// SLIC assignment step: nearest 5-D centre per pixel, first index on ties.
//
// Replaces the TPU kernel of the JAX package, ops/pallas/slic_assign.py
// (_assign_kernel, called through slic_assign_pallas), and the XLA assign it
// runs by default (ops/slic.py `_slic_core`, `assign`).  Two distance forms,
// one kernel template; both take the first k of minimal d2:
//
// direct (the Pallas kernel), with diff_d = f[p,d] - c[k,d]:
//   d2[k] = fma(diff_4, diff_4, fma(diff_3, diff_3, fma(diff_2, diff_2,
//               fma(diff_0, diff_0, rn(diff_1 * diff_1)))))
// That is the arithmetic the JAX kernel has on the CPU (interpret mode):
// XLA's CPU backend lets LLVM contract `d2 + diff*diff`, and where both
// operands of the first add are products LLVM fuses the left one (dimension
// 0) and keeps the right one (dimension 1) rounded.  Invalid centres carry
// the 1e6 sentinel, so no validity operand is needed.
//
// expanded (the JAX package's default, |p|^2 + |c|^2 - 2 p.c at HIGHEST):
//   p2 = rn(rn(rn(rn(f0*f0 + f1*f1) + f2*f2) + f3*f3) + f4*f4), every product
//        rounded (XLA's CPU reduce multiplies, then adds in order, unfused);
//   c2 the same over the centre, +inf for a centre that is not valid (as
//        `where(center_valid, d2, big)`: such a centre never wins);
//   dot = fma(f4, c4, fma(f3, c3, fma(f2, c2, fma(f1, c1, rn(f0 * c0)))))
//        (Eigen's matrix product, one fused chain over the 5-deep contraction);
//   d2[k] = rn(rn(p2 + c2) - 2 dot), computed as fma(-2, dot, p2 + c2): 2 dot
//        is exact, so the fused and unfused forms round alike.
// p2 is computed once per pixel and c2 once per centre.
//
// The plain versions (ops/cuda/slic_assign.py slic_assign_ref and
// slic_assign_expanded_ref) emulate the same roundings, so kernel, plain
// version and JAX give the same ids.
//
// What bounds it on an H100: instruction throughput (operations), not memory.  A
// pixel moves 24 bytes; at K = 256 it needs 256 x (5 FSUB + 1 FMUL + 4 FFMA +
// compare + 2 selects) = 13 instruction slots per pixel-centre pair in the
// direct form, 256 x (1 FMUL + 4 FFMA + FADD + FFMA + compare + 2 selects) =
// 10 in the expanded form, and the SM dispatches one warp instruction per
// scheduler per clock.
//
// What the design does about it: nothing but those slots may be spent per
// pair.  Each thread owns kPix = 4 pixels (features in registers), so one
// centre read from shared memory serves 4 pairs; centres are padded to 8
// floats (the expanded form keeps c2 in the sixth) and read as two 16-byte
// broadcast loads, 0.5 load slots per pair
// where the one-pixel design spent 5.  The block's 1024 pixels are staged
// through shared memory with coalesced loads (the features are stride-5, so a
// direct per-thread read would touch 5 sectors per load), and thread t takes
// pixels t, t+256, t+512, t+768 of the tile, which keeps the shared reads
// conflict-free (stride 5 is coprime with 32 banks) and the id stores
// coalesced.  The file is built with -fmad=false; the fusions are explicit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 4;                  // pixels per thread
constexpr int kTile = kThreads * kPix;   // pixels per block
constexpr int kDims = 5;
constexpr int kMaxK = 256;

// |x|^2 over 5 dimensions as XLA's CPU reduce computes it: products rounded,
// then added in order.
__device__ __forceinline__ float sq5(const float* x) {
  float s = __fmul_rn(x[0], x[0]);
#pragma unroll
  for (int d = 1; d < kDims; ++d) s = __fadd_rn(s, __fmul_rn(x[d], x[d]));
  return s;
}

template <bool kExpanded>
__global__ void __launch_bounds__(kThreads)
slic_assign_kernel(const float* __restrict__ feats,
                   const float* __restrict__ centers,
                   const uint8_t* __restrict__ center_valid,
                   int32_t* __restrict__ out, int mp, int k) {
  // centre c: (d0 d1 d2 d3), (d4 c2 0 0); c2 only in the expanded form
  __shared__ float4 c_s[kMaxK * 2];
  __shared__ float f_s[kTile * kDims];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kTile;
  const int n_here = min(kTile, mp - p0);

  const float* cb = centers + static_cast<size_t>(b) * k * kDims;
  float* c_flat = reinterpret_cast<float*>(c_s);
  for (int t = tid; t < k * 8; t += kThreads) {
    const int d = t & 7, c = t >> 3;
    float v = 0.0f;
    if (d < kDims) {
      v = cb[c * kDims + d];
    } else if (kExpanded && d == kDims) {
      v = center_valid[static_cast<size_t>(b) * k + c] ? sq5(cb + c * kDims)
                                                       : __int_as_float(0x7f800000);  // +inf
    }
    c_flat[t] = v;
  }
  const float* fb = feats + (static_cast<size_t>(b) * mp + p0) * kDims;
  for (int t = tid; t < n_here * kDims; t += kThreads) f_s[t] = fb[t];
  __syncthreads();

  float fv[kPix][kDims];
  float p2[kPix];
  float best[kPix];
  int best_k[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int p = tid + j * kThreads;
#pragma unroll
    for (int d = 0; d < kDims; ++d) fv[j][d] = p < n_here ? f_s[p * kDims + d] : 0.0f;
    p2[j] = kExpanded ? sq5(fv[j]) : 0.0f;
    best[j] = __int_as_float(0x7f800000);  // +inf
    best_k[j] = 0;
  }

#pragma unroll 2
  for (int c = 0; c < k; ++c) {
    const float4 lo = c_s[2 * c];
    const float2 hi = *reinterpret_cast<const float2*>(&c_s[2 * c + 1]);  // (c4, c2)
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      float d2;
      if (kExpanded) {
        float dot = __fmul_rn(fv[j][0], lo.x);
        dot = __fmaf_rn(fv[j][1], lo.y, dot);
        dot = __fmaf_rn(fv[j][2], lo.z, dot);
        dot = __fmaf_rn(fv[j][3], lo.w, dot);
        dot = __fmaf_rn(fv[j][4], hi.x, dot);
        d2 = __fmaf_rn(-2.0f, dot, __fadd_rn(p2[j], hi.y));
      } else {
        const float e0 = __fsub_rn(fv[j][0], lo.x);
        const float e1 = __fsub_rn(fv[j][1], lo.y);
        const float e2 = __fsub_rn(fv[j][2], lo.z);
        const float e3 = __fsub_rn(fv[j][3], lo.w);
        const float e4 = __fsub_rn(fv[j][4], hi.x);
        d2 = __fmaf_rn(e0, e0, __fmul_rn(e1, e1));
        d2 = __fmaf_rn(e2, e2, d2);
        d2 = __fmaf_rn(e3, e3, d2);
        d2 = __fmaf_rn(e4, e4, d2);
      }
      if (d2 < best[j]) {  // strict: the first index wins a tie
        best[j] = d2;
        best_k[j] = c;
      }
    }
  }

  int32_t* ob = out + static_cast<size_t>(b) * mp + p0;
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int p = tid + j * kThreads;
    if (p < n_here) ob[p] = best_k[j];
  }
}

}  // namespace

extern "C" {

// feats (B, MP, 5) f32, centers (B, K, 5) f32 with K <= 256, out (B, MP)
// int32, all contiguous on the device.  The direct form; invalid centres
// carry the 1e6 sentinel.  Launches on `stream`; returns cudaGetLastError().
int slic_assign_launch(const float* feats, const float* centers, int32_t* out,
                       int batch, int mp, int k, void* stream) {
  if (batch <= 0 || mp <= 0) return 0;
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((mp + kTile - 1) / kTile, batch);
  slic_assign_kernel<false><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      feats, centers, nullptr, out, mp, k);
  return static_cast<int>(cudaGetLastError());
}

// The expanded form: as slic_assign_launch, with center_valid (B, K) uint8
// (0: the centre never wins).
int slic_assign_expanded_launch(const float* feats, const float* centers,
                                const uint8_t* center_valid, int32_t* out,
                                int batch, int mp, int k, void* stream) {
  if (batch <= 0 || mp <= 0) return 0;
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((mp + kTile - 1) / kTile, batch);
  slic_assign_kernel<true><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      feats, centers, center_valid, out, mp, k);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
