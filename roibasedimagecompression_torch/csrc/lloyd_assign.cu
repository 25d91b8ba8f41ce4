// Lloyd's assignment pass: the nearest of a row's first k centres for every
// point of every row, first index on ties.
//
// Replaces no Pallas kernel.  The JAX package assigns in XLA (its
// ops/cluster.py `kmeans`, the assignment over `_sq_dists`); the port
// computed the same distances as about fifty float64 elementwise launches a
// chunk of points (ops/cuda/lloyd_assign.py assign_plain, still the CPU's
// route and the oracle of the tests).  Here one launch assigns every point
// of every row, in XLA's float32 CPU arithmetic:
//
//   a2 = fma(az, az, fma(a1, a1, rn(a0 * a0)))        once a point
//   c2 = fma(cz, cz, fma(c1, c1, rn(c0 * c0)))        once a centre
//   ab = fma(az, cz, fma(a1, c1, rn(a0 * c0)))
//   d2 = max(rn(rn(a2 + c2) - 2 ab), 0)
//
// computed as max(fma(-2, ab, rn(a2 + c2)), 0): 2 ab is exact, so the fused
// and unfused forms round alike.  Centres j >= k[b] never win (the plain
// version gives them 3.4e38); the label is the first j of minimal d2, 0 in a
// row with no centre.  Every point of the padded row is assigned, padding
// included.  The file is built with -fmad=false; the fusions are explicit.
//
// What bounds it on an H100: instruction issue, not memory.  A pair costs a
// multiply, three fused multiply-adds, an add, the clamp, the compare and two
// selects, 9 instruction slots, where a point moves 20 bytes (12 read, 8
// written).  The roofline counts the 9 as operations against 67 TFLOP/s, a
// rate that takes a multiply-add as two; an SM issues one instruction a lane
// and clock, so 9 slots a pair reach at most half of that bound.
//
// What the design does about it: nothing but those slots is spent per pair.
// Each thread keeps kPix = 4 points in registers (a2, best and its index
// beside them), so one centre, read from shared memory as a broadcast float4
// with c2 in its fourth lane, serves 4 pairs: a quarter of a load slot a
// pair.  Centres are staged in tiles of kTile, c2 computed once as they are
// staged, and the running (min, index) is carried across tiles with a strict
// <, so any k_max works.  Where one row's points give too few blocks to fill
// the card (tier 1's single rows of 16k-131k points), the block's threads
// split into kSplit groups over the same points, each group taking a
// contiguous share of every tile; the groups' minima are combined at the end
// by (d2, index), so the first index still wins.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 4;      // points a thread
constexpr int kTile = 1024;  // centres a tile in shared memory (16 KiB)

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
}

template <int kSplit>
__global__ void __launch_bounds__(kThreads, 4)
lloyd_assign_kernel(const float* __restrict__ points, const float* __restrict__ centers,
                    const int64_t* __restrict__ k, int64_t* __restrict__ labels, int m, int k_max) {
  constexpr int kGroup = kThreads / kSplit;  // threads a group
  constexpr int kPoints = kGroup * kPix;     // points a block
  __shared__ float4 c_s[kTile];              // (c0, c1, cz, c2)
  __shared__ float red_v[kSplit > 1 ? (kSplit - 1) * kPoints : 1];
  __shared__ int red_i[kSplit > 1 ? (kSplit - 1) * kPoints : 1];

  const int tid = threadIdx.x;
  const int s = tid / kGroup;
  const int lt = tid % kGroup;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kPoints;
  const int64_t kr = k[b];
  const int kb = kr < 0 ? 0 : (kr > k_max ? k_max : static_cast<int>(kr));

  const float* pb = points + static_cast<size_t>(b) * m * 3;
  float a0[kPix], a1[kPix], az[kPix], a2[kPix], best[kPix];
  int best_j[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int p = p0 + lt + j * kGroup;
    a0[j] = p < m ? pb[3 * static_cast<size_t>(p)] : 0.0f;
    a1[j] = p < m ? pb[3 * static_cast<size_t>(p) + 1] : 0.0f;
    az[j] = p < m ? pb[3 * static_cast<size_t>(p) + 2] : 0.0f;
    a2[j] = sq3(a0[j], a1[j], az[j]);
    best[j] = __int_as_float(0x7f800000);  // +inf
    best_j[j] = 0;
  }

  const float* cb = centers + static_cast<size_t>(b) * k_max * 3;
  for (int t0 = 0; t0 < kb; t0 += kTile) {
    const int n = min(kTile, kb - t0);
    __syncthreads();  // the previous tile is consumed
    for (int c = tid; c < n; c += kThreads) {
      const float x = cb[3 * (t0 + c)], y = cb[3 * (t0 + c) + 1], z = cb[3 * (t0 + c) + 2];
      c_s[c] = make_float4(x, y, z, sq3(x, y, z));
    }
    __syncthreads();
    const int per = (n + kSplit - 1) / kSplit;
    const int lo = s * per;
    const int hi = min(n, lo + per);
#pragma unroll 4
    for (int c = lo; c < hi; ++c) {
      const float4 cc = c_s[c];
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        const float ab = __fmaf_rn(az[j], cc.z, __fmaf_rn(a1[j], cc.y, __fmul_rn(a0[j], cc.x)));
        const float d2 = fmaxf(__fmaf_rn(-2.0f, ab, __fadd_rn(a2[j], cc.w)), 0.0f);
        if (d2 < best[j]) {  // strict: the first index wins a tie
          best[j] = d2;
          best_j[j] = t0 + c;
        }
      }
    }
  }

  if (kSplit > 1) {
    if (s > 0) {
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        red_v[(s - 1) * kPoints + j * kGroup + lt] = best[j];
        red_i[(s - 1) * kPoints + j * kGroup + lt] = best_j[j];
      }
    }
    __syncthreads();
    if (s == 0) {
      for (int r = 0; r < kSplit - 1; ++r) {
#pragma unroll
        for (int j = 0; j < kPix; ++j) {
          const float v = red_v[r * kPoints + j * kGroup + lt];
          const int i = red_i[r * kPoints + j * kGroup + lt];
          if (v < best[j] || (v == best[j] && i < best_j[j])) {
            best[j] = v;
            best_j[j] = i;
          }
        }
      }
    }
  }
  if (s == 0) {
    int64_t* ob = labels + static_cast<size_t>(b) * m;
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const int p = p0 + lt + j * kGroup;
      if (p < m) ob[p] = best_j[j];
    }
  }
}

template <int kSplit>
int launch(const float* points, const float* centers, const int64_t* k, int64_t* labels, int batch,
           int m, int k_max, cudaStream_t stream) {
  constexpr int kPoints = kThreads / kSplit * kPix;
  dim3 grid((m + kPoints - 1) / kPoints, batch);
  lloyd_assign_kernel<kSplit><<<grid, kThreads, 0, stream>>>(points, centers, k, labels, m, k_max);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// points (B, m, 3) f32, centers (B, k_max, 3) f32, k (B,) int64, labels
// (B, m) int64, all contiguous on the device; split 1, 2, 4 or 8 (the
// groups a block's threads form over its points, ops/cuda/lloyd_assign.py
// plan).  Launches on `stream`; returns cudaGetLastError().
int lloyd_assign_launch(const float* points, const float* centers, const int64_t* k, int64_t* labels,
                        int batch, int m, int k_max, int split, void* stream) {
  if (batch <= 0 || m <= 0) return 0;
  if (k_max < 1 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (split) {
    case 1: return launch<1>(points, centers, k, labels, batch, m, k_max, st);
    case 2: return launch<2>(points, centers, k, labels, batch, m, k_max, st);
    case 4: return launch<4>(points, centers, k, labels, batch, m, k_max, st);
    case 8: return launch<8>(points, centers, k, labels, batch, m, k_max, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
