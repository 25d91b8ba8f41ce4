// SLIC assignment step: nearest 5-D centre per pixel, first index on ties.
//
// Replaces the TPU kernel of the JAX package, ops/pallas/slic_assign.py
// (_assign_kernel, called through slic_assign_pallas).  For every pixel p of
// batch row b, with diff_d = f[p,d] - c[k,d]:
//   d2[k] = fma(diff_4, diff_4, fma(diff_3, diff_3, fma(diff_2, diff_2,
//               fma(diff_0, diff_0, rn(diff_1 * diff_1)))))
// and out[p] = the first k of minimal d2.  That is the arithmetic the JAX
// kernel has on the CPU (interpret mode): XLA's CPU backend lets LLVM contract
// `d2 + diff*diff`, and where both operands of the first add are products
// LLVM fuses the left one (dimension 0) and keeps the right one (dimension 1)
// rounded.  The plain version (ops/cuda/slic_assign.py slic_assign_ref)
// emulates the same five roundings, so kernel, plain version and JAX kernel
// give the same ids.  Invalid centres carry the 1e6 sentinel, so no validity
// operand is needed.
//
// What bounds it on an H100: instruction throughput (operations), not memory.  A
// pixel moves 24 bytes; at K = 256 it needs 256 x (5 FSUB + 1 FMUL + 4 FFMA +
// compare + 2 selects) = 13 instruction slots per pixel-centre pair, and the SM
// dispatches one warp instruction per scheduler per clock.
//
// What the design does about it: nothing but those 13 slots may be spent per
// pair.  Each thread owns kPix = 4 pixels (features in registers), so one
// centre read from shared memory serves 4 pairs; centres are padded to 8
// floats and read as two 16-byte broadcast loads, 0.5 load slots per pair
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

__global__ void __launch_bounds__(kThreads)
slic_assign_kernel(const float* __restrict__ feats,
                   const float* __restrict__ centers,
                   int32_t* __restrict__ out, int mp, int k) {
  __shared__ float4 c_s[kMaxK * 2];      // centre c: (d0 d1 d2 d3), (d4 0 0 0)
  __shared__ float f_s[kTile * kDims];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kTile;
  const int n_here = min(kTile, mp - p0);

  const float* cb = centers + static_cast<size_t>(b) * k * kDims;
  float* c_flat = reinterpret_cast<float*>(c_s);
  for (int t = tid; t < k * 8; t += kThreads) {
    const int d = t & 7;
    c_flat[t] = d < kDims ? cb[(t >> 3) * kDims + d] : 0.0f;
  }
  const float* fb = feats + (static_cast<size_t>(b) * mp + p0) * kDims;
  for (int t = tid; t < n_here * kDims; t += kThreads) f_s[t] = fb[t];
  __syncthreads();

  float fv[kPix][kDims];
  float best[kPix];
  int best_k[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int p = tid + j * kThreads;
#pragma unroll
    for (int d = 0; d < kDims; ++d) fv[j][d] = p < n_here ? f_s[p * kDims + d] : 0.0f;
    best[j] = __int_as_float(0x7f800000);  // +inf
    best_k[j] = 0;
  }

#pragma unroll 2
  for (int c = 0; c < k; ++c) {
    const float4 lo = c_s[2 * c];
    const float c4 = c_s[2 * c + 1].x;
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const float e0 = __fsub_rn(fv[j][0], lo.x);
      const float e1 = __fsub_rn(fv[j][1], lo.y);
      const float e2 = __fsub_rn(fv[j][2], lo.z);
      const float e3 = __fsub_rn(fv[j][3], lo.w);
      const float e4 = __fsub_rn(fv[j][4], c4);
      float d2 = __fmaf_rn(e0, e0, __fmul_rn(e1, e1));
      d2 = __fmaf_rn(e2, e2, d2);
      d2 = __fmaf_rn(e3, e3, d2);
      d2 = __fmaf_rn(e4, e4, d2);
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
// int32, all contiguous on the device.  Launches on `stream`; returns
// cudaGetLastError().
int slic_assign_launch(const float* feats, const float* centers, int32_t* out,
                       int batch, int mp, int k, void* stream) {
  if (batch <= 0 || mp <= 0) return 0;
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((mp + kTile - 1) / kTile, batch);
  slic_assign_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      feats, centers, out, mp, k);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
