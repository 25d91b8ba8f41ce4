// k-means++ Gumbel noise: a (n_draws, m) float32 table, row i the draw of
// the i-th k-means++ step.
//
// Replaces no TPU kernel.  The JAX package draws this noise inside its jitted
// k-means (its ops/cluster.py `kmeans`: jax.random.gumbel under `key, sub =
// split(key)` per step), which XLA compiles to device code; the port drew it
// on the host (ops/cluster.py `_gumbel_table`, numpy threefry) and copied it
// over.  This kernel computes the same bits on the card.
//
// The bit contract (JAX's partitionable threefry, ops/prng.py): element j of
// row i is
//   (a, b) = threefry2x32(sub_i, hi32(j), lo32(j)),  bits = a ^ b,
//   f = bitcast((bits >> 9) | 0x3F800000) - 1,        in [0, 1),
//   u = max(tiny, f * (1 - tiny) + tiny),             two roundings,
//   g = -log32(-log32(u)),
// with sub_i the i-th sub-key of the split chain of PRNGKey(seed), tiny the
// least normal float32 and log32 XLA's CPU float32 logarithm (a Cephes logf,
// ops/prng.py `log32`).  The bits of element j depend on sub_i and j alone,
// so the table of (seed, m, n) is the prefix [:n, :m] of the table of any
// (seed, M >= m, N >= n): the wrapper keeps one chain of sub-keys per seed and
// draws any table from it.
//
// Roundings: log32 fuses a multiply into its add (fmaf) exactly where
// ops/prng.py `log32` calls `fma32`: the three two-step q polynomials, the
// two r steps, y, fma(-0.5, z, t) and the exponent term.  Every other
// operation is rounded on its own: t*t, z*t, e*C9, the add of y, and the
// uniform's f*(1 - tiny) + tiny.  They are written as __fmul_rn / __fadd_rn,
// which nvcc never contracts; the build's -fmad=false keeps any plain
// expression from being contracted besides.  Zero and subnormal input to
// log32 give -inf, as under XLA's flush-to-zero.
//
// What bounds it on an H100: integer instructions.  An element is about 82
// integer operations (threefry's 20 rounds of add, rotate and xor, its 5 key
// injections, the mantissa trick, two exponent extractions, the index) on
// the SM's 64 INT32 lanes, about 48 float operations on its 128 FP32 lanes,
// and 4 bytes written; at (256, 16384) that is about 21 us of integer instructions
// against 5 us of writes.
//
// What the design does about it: nothing but the element's own work is
// spent.  A block owns a 2,048-element tile of one row; its sub-key and the
// key schedule (with each injection's round constant folded in) are read and
// formed once a block, and each thread makes 8 elements at a stride of the
// block width, so the stores of a warp are coalesced and the 8 hashes are
// independent chains the scheduler can interleave.  No shared-memory staging
// is needed for a pure generator.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;                   // elements per thread
constexpr int kTile = kThreads * kPer;    // elements per block

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// XLA's CPU float32 log, as ops/prng.py `log32`: mantissa in [sqrt(1/2),
// sqrt(2)), a degree-8 polynomial in three pieces, exponent times ln 2 in
// two parts.
__device__ __forceinline__ float log32(float x) {
  const float tiny = 0x1p-126f;
  const int bits = __float_as_int(fmaxf(x, tiny));
  float e = static_cast<float>((bits >> 23) - 126);
  const float m = __int_as_float((bits & 0x007FFFFF) | 0x3F000000);
  const bool low = m < 0x1.6a09e6p-1f;  // sqrt(1/2)
  e = __fsub_rn(e, low ? 1.0f : 0.0f);
  const float t = __fadd_rn(__fsub_rn(m, 1.0f), low ? m : 0.0f);
  const float z = __fmul_rn(t, t);
  const float t3 = __fmul_rn(z, t);
  const float q0 = __fmaf_rn(__fmaf_rn(t, 0x1.204376p-4f, -0x1.d7a370p-4f), t, 0x1.de4a34p-4f);
  const float q1 = __fmaf_rn(__fmaf_rn(t, -0x1.fcba9ep-4f, 0x1.23d37ep-3f), t, -0x1.555ca0p-3f);
  const float q2 = __fmaf_rn(__fmaf_rn(t, 0x1.999d58p-3f, -0x1.fffff8p-3f), t, 0x1.555554p-2f);
  const float r = __fmaf_rn(__fmaf_rn(q0, t3, q1), t3, q2);
  const float y = __fmaf_rn(r, t3, __fmul_rn(e, -0x1.bd0106p-13f));
  const float out = __fmaf_rn(0x1.630000p-1f, e, __fadd_rn(__fmaf_rn(-0.5f, z, t), y));
  return x < tiny ? -__int_as_float(0x7F800000) : out;
}

__global__ void __launch_bounds__(kThreads)
gumbel_kernel(const uint32_t* __restrict__ keys, float* __restrict__ out, int m) {
  __shared__ uint32_t key_s[2];
  const int row = blockIdx.y;
  if (threadIdx.x < 2) key_s[threadIdx.x] = keys[2 * row + threadIdx.x];
  __syncthreads();
  const uint32_t k0 = key_s[0], k1 = key_s[1];
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  // The injection after group g adds ks[(g+1)%3] to a and ks[(g+2)%3] + g + 1
  // to b (ops/prng.py `threefry2x32`).
  const uint32_t ka[5] = {k1, k2, k0, k1, k2};
  const uint32_t kb[5] = {k2 + 1u, k0 + 2u, k1 + 3u, k2 + 4u, k0 + 5u};
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};

  float* orow = out + static_cast<size_t>(row) * m;
  const int base = blockIdx.x * kTile + threadIdx.x;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int j = base + p * kThreads;
    if (j >= m) break;
    uint32_t a = 0u + k0;  // hi32(j) = 0: m < 2^31
    uint32_t b = static_cast<uint32_t>(j) + k1;
#pragma unroll
    for (int g = 0; g < 5; ++g) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        a += b;
        b = rotl(b, kRot[g % 2][s]);
        b ^= a;
      }
      a += ka[g];
      b += kb[g];
    }
    const uint32_t bits = a ^ b;
    const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
    const float tiny = 0x1p-126f;
    const float u = fmaxf(tiny, __fadd_rn(__fmul_rn(f, 1.0f - tiny), tiny));
    orow[j] = -log32(-log32(u));
  }
}

}  // namespace

extern "C" {

// keys (n_draws, 2) uint32 sub-keys, out (n_draws, m) float32, both
// contiguous on the device.  Launches on `stream`; returns
// cudaGetLastError().
int gumbel_launch(const uint32_t* keys, float* out, int n_draws, int m, void* stream) {
  if (n_draws <= 0 || m <= 0) return 0;
  if (n_draws > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((m + kTile - 1) / kTile, n_draws);
  gumbel_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(keys, out, m);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
