// SLIC assignment step: nearest 5-D centre per pixel, first index on ties.
//
// Replaces the TPU kernel of the JAX package, ops/pallas/slic_assign.py
// (_assign_kernel, called through slic_assign_pallas).  For every pixel p of
// batch row b:  d2[k] = sum_d (f[p,d] - c[k,d])^2, accumulated dimension by
// dimension d = 0..4 in that order, and out[p] = the first k of minimal d2.
// Invalid centres carry the 1e6 sentinel, so no validity operand is needed.
//
// What bounds it on an H100: operations.  A pixel reads 20 bytes and its
// row's centres are shared, so at K = 256 each pixel costs ~17 float32
// operations per centre (5 sub, 5 mul, 5 add, compare, select) against 24
// bytes of traffic: ~180 operations per byte, far above the card's
// float32-to-bandwidth ratio (67 TFLOP/s over 3.35 TB/s = ~20).
//
// The simple design: one block of 256 threads per (pixel tile, batch row);
// the row's K <= 256 centres are staged once in shared memory (<= 5 KB) and
// read as broadcasts; each thread owns one pixel and keeps the running
// minimum and its index in registers.  Every product and sum is rounded on
// its own (__fsub_rn/__fmul_rn/__fadd_rn, and the file is built with
// -fmad=false), so the ids equal the plain PyTorch version bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDims = 5;

__global__ void slic_assign_kernel(const float* __restrict__ feats,
                                   const float* __restrict__ centers,
                                   int32_t* __restrict__ out, int mp, int k) {
  extern __shared__ float c_s[];
  const int b = blockIdx.y;
  const float* cb = centers + static_cast<size_t>(b) * k * kDims;
  for (int t = threadIdx.x; t < k * kDims; t += blockDim.x) c_s[t] = cb[t];
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= mp) return;
  const float* f = feats + (static_cast<size_t>(b) * mp + p) * kDims;
  float fv[kDims];
#pragma unroll
  for (int d = 0; d < kDims; ++d) fv[d] = f[d];

  float best = __int_as_float(0x7f800000);  // +inf
  int best_k = 0;
  for (int c = 0; c < k; ++c) {
    const float* cc = c_s + c * kDims;
    float d2 = 0.0f;
#pragma unroll
    for (int d = 0; d < kDims; ++d) {
      const float diff = __fsub_rn(fv[d], cc[d]);
      d2 = __fadd_rn(d2, __fmul_rn(diff, diff));
    }
    if (d2 < best) {  // strict: the first index wins a tie
      best = d2;
      best_k = c;
    }
  }
  out[static_cast<size_t>(b) * mp + p] = best_k;
}

}  // namespace

extern "C" {

// feats (B, MP, 5) f32, centers (B, K, 5) f32, out (B, MP) int32, all
// contiguous on the device.  Launches on `stream`; returns cudaGetLastError().
int slic_assign_launch(const float* feats, const float* centers, int32_t* out,
                       int batch, int mp, int k, void* stream) {
  if (batch <= 0 || mp <= 0) return 0;
  dim3 grid((mp + kThreads - 1) / kThreads, batch);
  const size_t smem = static_cast<size_t>(k) * kDims * sizeof(float);
  slic_assign_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      feats, centers, out, mp, k);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
