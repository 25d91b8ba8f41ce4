// SLIC's working-resolution resize: PIL's antialiased bilinear downscale
// (Image.resize(..., BILINEAR)) of many RGB uint8 crops in one launch.
//
// Replaces no TPU kernel.  The JAX package resizes each working image with
// PIL on the host (its models/segment.py, the SLIC step of
// region_segments_many); the port did the same in numpy
// (models/segment.py `_resize_uint8`) and uploaded the result, although
// the unscaled crop already lay on the card in the device batch.  This
// kernel reads each crop where it lies and writes the resized rows on the
// card, with the same bits.
//
// The arithmetic is PIL's 8-bit path (libImaging/Resample.c), as
// ops/cuda/resample.py `resize_plain` states it: the coefficients of an
// (in, out) pair are computed on the host in float64 and rounded to 22-bit
// integers, one table row an output index: [start, count, w_0 .. w_{k-1}].
// The horizontal pass runs first, then the vertical pass on its output.
// Each output value is
//   clip((2^21 + sum_t in[start + t] * w_t) >> 22, 0, 255)
// over t < count; the horizontal pass is rounded and clipped into uint8
// before the vertical pass reads it.  The weights are non-negative and sum
// to about 2^22, so every sum fits an int32 (255 * (2^22 + count) + 2^21 <
// 2^31) and integer addition makes the order of the taps immaterial.  An
// axis whose size does not change gets no pass (its table pointer is null).
//
// What bounds it on an H100: bytes and the launch.  A 768x512 crop resized
// to 537x358 reads 1.18 MB, writes 0.58 MB and takes 4.0 M integer
// multiply-adds: for a batch of 8 about 4.2 us of memory traffic at
// 3.35 TB/s and 1.9 us of INT32 issue, against a launch's 5-10 us of host
// time.  A 2048x1365 crop resized to 409x273 (up to 13 taps) reads 8.4 MB
// and takes 20.1 M multiply-adds: 20.8 us of traffic for 8.
//
// What the design does about it: every row of one call goes into one
// launch, each crop is read once from where it lies (a row pitch per
// descriptor, so a slice of the device batch needs no copy), and the
// horizontal pass's output never goes to device memory.  A block owns a
// 16x32 output tile of one row (a block-to-row table of prefix sums in the
// descriptors, searched by one thread); it runs the horizontal pass over
// the band of input rows its tile needs, 32 rows at a time, into shared
// memory, and each thread adds the staged rows into the vertical sums of
// its 2 output pixels.  Neighbouring tiles recompute the few input rows
// their bands share (10-16 % more horizontal work at the codec's scales).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTX = 32;                         // output columns a tile
constexpr int kTY = 16;                         // output rows a tile
constexpr int kPix = kTX * kTY / kThreads;      // output pixels a thread
constexpr int kChunk = 32;                      // input rows staged at a time
constexpr int kShift = 22;                      // PIL's PRECISION_BITS
constexpr int kBias = 1 << (kShift - 1);

// Descriptor fields, int64 each, one descriptor a row.
enum {
  kSrc,      // address of in[0][0][0]; pixels of a row contiguous
  kPitch,    // bytes from one input row to the next
  kHIn, kWIn, kHOut, kWOut,
  kDst,      // address of the contiguous (h_out, w_out, 3) output
  kXTab,     // address of the horizontal table (int32, w_out rows), 0: no pass
  kXTaps,    // its taps a row (row width - 2)
  kYTab, kYTaps,
  kTile0,    // first block of this row: prefix sum of the rows' tiles
  kFields
};

__device__ __forceinline__ int clip8(int acc) { return min(max(acc >> kShift, 0), 255); }

__global__ void __launch_bounds__(kThreads)
resample_kernel(const long long* __restrict__ desc, int n_rows) {
  __shared__ uint8_t mid[kChunk][kTX * 3];
  __shared__ int row_s;
  if (threadIdx.x == 0) {
    int lo = 0, hi = n_rows - 1;  // the last row whose first block <= blockIdx.x
    while (lo < hi) {
      const int m = (lo + hi + 1) / 2;
      if (desc[m * kFields + kTile0] <= static_cast<long long>(blockIdx.x)) lo = m; else hi = m - 1;
    }
    row_s = lo;
  }
  __syncthreads();
  const long long* d = desc + static_cast<long long>(row_s) * kFields;
  const uint8_t* src = reinterpret_cast<const uint8_t*>(d[kSrc]);
  const long long pitch = d[kPitch];
  const int h_out = static_cast<int>(d[kHOut]), w_out = static_cast<int>(d[kWOut]);
  uint8_t* dst = reinterpret_cast<uint8_t*>(d[kDst]);
  const int* xt = reinterpret_cast<const int*>(d[kXTab]);
  const int* yt = reinterpret_cast<const int*>(d[kYTab]);
  const int xw = static_cast<int>(d[kXTaps]) + 2, yw = static_cast<int>(d[kYTaps]) + 2;

  const int tiles_x = (w_out + kTX - 1) / kTX;
  const int tile = static_cast<int>(blockIdx.x - d[kTile0]);
  const int oy0 = (tile / tiles_x) * kTY, ox0 = (tile % tiles_x) * kTX;
  const int ny = min(kTY, h_out - oy0), nx = min(kTX, w_out - ox0);
  // The band of input rows the tile's output rows read: starts and ends
  // rise with the output index.
  int ylo = oy0, yhi = oy0 + ny;
  if (yt) {
    ylo = yt[oy0 * yw];
    yhi = yt[(oy0 + ny - 1) * yw] + yt[(oy0 + ny - 1) * yw + 1];
  }

  int acc[kPix][3];
#pragma unroll
  for (int p = 0; p < kPix; ++p) acc[p][0] = acc[p][1] = acc[p][2] = kBias;

  const int band_w = nx * 3;
  for (int c0 = ylo; c0 < yhi; c0 += kChunk) {
    const int nr = min(kChunk, yhi - c0);
    // Horizontal pass of input rows c0 .. c0 + nr - 1 over the tile's columns.
    for (int e = threadIdx.x; e < nr * band_w; e += kThreads) {
      const int r = e / band_w, rest = e - r * band_w;
      const int c = rest / 3, ch = rest - 3 * c;
      const uint8_t* s = src + static_cast<long long>(c0 + r) * pitch + ch;
      int v;
      if (xt) {
        const int* co = xt + (ox0 + c) * xw;
        const int x0 = co[0], cnt = co[1];
        int a = kBias;
        for (int t = 0; t < cnt; ++t) a += static_cast<int>(s[(x0 + t) * 3]) * co[2 + t];
        v = clip8(a);
      } else {
        v = s[(ox0 + c) * 3];
      }
      mid[r][rest] = static_cast<uint8_t>(v);
    }
    __syncthreads();
    // Vertical pass: each thread adds the staged rows its pixels read.
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      const int q = threadIdx.x + p * kThreads;
      const int oy = q / kTX, ox = q - (q / kTX) * kTX;
      if (oy >= ny || ox >= nx) continue;
      const uint8_t* m = &mid[0][ox * 3];
      if (yt) {
        const int* co = yt + (oy0 + oy) * yw;
        const int y0 = co[0];
        const int lo = max(y0, c0), hi = min(y0 + co[1], c0 + nr);
        for (int y = lo; y < hi; ++y) {
          const int w = co[2 + y - y0];
          const uint8_t* px = m + (y - c0) * (kTX * 3);
          acc[p][0] += static_cast<int>(px[0]) * w;
          acc[p][1] += static_cast<int>(px[1]) * w;
          acc[p][2] += static_cast<int>(px[2]) * w;
        }
      } else if (oy0 + oy >= c0 && oy0 + oy < c0 + nr) {
        const uint8_t* px = m + (oy0 + oy - c0) * (kTX * 3);
        acc[p][0] = px[0];
        acc[p][1] = px[1];
        acc[p][2] = px[2];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int q = threadIdx.x + p * kThreads;
    const int oy = q / kTX, ox = q - (q / kTX) * kTX;
    if (oy >= ny || ox >= nx) continue;
    uint8_t* out = dst + (static_cast<long long>(oy0 + oy) * w_out + ox0 + ox) * 3;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) out[ch] = static_cast<uint8_t>(yt ? clip8(acc[p][ch]) : acc[p][ch]);
  }
}

}  // namespace

extern "C" {

// desc (n_rows, 12) int64 descriptors on the device (fields above), their
// kTile0 the prefix sums of each row's ceil(h_out / 16) * ceil(w_out / 32)
// tiles, n_blocks the sum of all.  Launches on `stream`; returns
// cudaGetLastError().
int resample_launch(const long long* desc, int n_rows, int n_blocks, void* stream) {
  if (n_rows <= 0 || n_blocks <= 0) return 0;
  resample_kernel<<<n_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(desc, n_rows);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
