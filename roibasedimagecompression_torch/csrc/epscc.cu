// One masked-min label sweep of the eps-graph over palette colours.
//
// Replaces the TPU kernel of the JAX package, ops/pallas/epscc.py
// (_sweep_kernel, called through eps_sweep_pallas and driven by
// eps_components_pallas).  For every point i of batch row b:
//   out[i] = min label[j] over j with valid[j], d2(i, j) <= eps2[b],
//            group[j] == group[i] and group[i] >= 0;   INT32_MAX if none.
// d2 is summed channel by channel (c = 0, 1, 2) in float32; the points are
// integer colours <= 255, so d2 <= 195075 is exact and the comparison with
// eps2 = float32(eps)**2 matches the TPU kernel and the host union-find.
// The driver around it (min-combine, pointer-jump hops, loop until nothing
// changes) is ops/cuda/epscc.py.
//
// What bounds it on an H100: operations.  A sweep of an N-point row does N^2
// pair tests of ~12 operations (3 sub, 3 mul, 3 add, distance and group
// compares, select) against 20 N bytes read: compute-bound for any bucket
// (N >= 64).
//
// The simple design: a block of 256 threads owns 256 rows (points i) of one
// batch row; it streams the row's columns through shared memory in tiles of
// 256 (x, y, z, label, group with invalid columns folded to group -1), and
// each thread keeps its running minimum label in a register.  All loads of a
// tile are coalesced and every thread reads each shared value as a broadcast.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;

__global__ void eps_sweep_kernel(const float* __restrict__ points,
                                 const int32_t* __restrict__ labels,
                                 const uint8_t* __restrict__ valid,
                                 const int32_t* __restrict__ groups,
                                 const float* __restrict__ eps2,
                                 int32_t* __restrict__ out, int n) {
  __shared__ float xs[kTile], ys[kTile], zs[kTile];
  __shared__ int32_t ls[kTile], gs[kTile];

  const int b = blockIdx.y;
  const size_t base = static_cast<size_t>(b) * n;
  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool row_ok = i < n;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  int32_t gi = -1;
  if (row_ok) {
    xi = points[(base + i) * 3 + 0];
    yi = points[(base + i) * 3 + 1];
    zi = points[(base + i) * 3 + 2];
    gi = groups[base + i];
  }
  const float e2 = eps2[b];
  int32_t best = INT32_MAX;

  for (int j0 = 0; j0 < n; j0 += kTile) {
    const int j = j0 + threadIdx.x;
    if (j < n) {
      xs[threadIdx.x] = points[(base + j) * 3 + 0];
      ys[threadIdx.x] = points[(base + j) * 3 + 1];
      zs[threadIdx.x] = points[(base + j) * 3 + 2];
      ls[threadIdx.x] = labels[base + j];
      gs[threadIdx.x] = valid[base + j] ? groups[base + j] : -1;
    } else {
      gs[threadIdx.x] = -1;
    }
    __syncthreads();
    if (gi >= 0) {
      const int m = min(kTile, n - j0);
      for (int t = 0; t < m; ++t) {
        float d = __fsub_rn(xi, xs[t]);
        float d2 = __fmul_rn(d, d);
        d = __fsub_rn(yi, ys[t]);
        d2 = __fadd_rn(d2, __fmul_rn(d, d));
        d = __fsub_rn(zi, zs[t]);
        d2 = __fadd_rn(d2, __fmul_rn(d, d));
        if (d2 <= e2 && gs[t] == gi) best = min(best, ls[t]);
      }
    }
    __syncthreads();
  }
  if (row_ok) out[base + i] = best;
}

}  // namespace

extern "C" {

// points (B, N, 3) f32, labels (B, N) int32, valid (B, N) uint8,
// groups (B, N) int32, eps2 (B,) f32, out (B, N) int32, all contiguous on the
// device.  Launches on `stream`; returns cudaGetLastError().
int eps_sweep_launch(const float* points, const int32_t* labels,
                     const uint8_t* valid, const int32_t* groups,
                     const float* eps2, int32_t* out, int batch, int n,
                     void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  dim3 grid((n + kTile - 1) / kTile, batch);
  eps_sweep_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      points, labels, valid, groups, eps2, out, n);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
