// eps-graph connected components over palette colours: the masked-min label
// sweep and the loop that drives it, both on the card.
//
// Replaces the TPU kernel of the JAX package, ops/pallas/epscc.py
// (_sweep_kernel, called through eps_sweep_pallas) and the jitted while_loop
// around it (eps_components_pallas).  One sweep gives, for every point i of
// batch row b,
//   out[i] = min label[j] over j with valid[j], d2(i, j) <= eps2[b],
//            group[j] == group[i] and group[i] >= 0;   INT32_MAX if none.
// The loop min-combines the proposals into the labels, shortens the label
// chains and repeats until nothing changes; each component then carries its
// least point index.
//
// What bounds it on an H100: instruction throughput (operations).  A sweep of an
// N-point row is N^2 pair tests against 16 N bytes, and the tests are integer
// work, which the SM executes at 64 lanes per clock.  As compiled, a pair costs
// 5.5 integer instructions: VABSDIFF4, IDP4A, two ISETP, a SEL and half of a
// three-input VIMNMX.
//
// What the design does about it:
//  - Exact integer distance in two instructions.  Colours are integers <= 255,
//    packed once per call as one 32-bit word (three bytes, the fourth 0):
//    d2 = __dp4a(diff, diff, 0) of diff = __vabsdiffu4(a, b).  For an integer
//    d2 >= 0, `d2 <= eps2` in float32 and `d2 <= (int)floorf(eps2)` are the
//    same predicate.  Groups stay an int32 compare; invalid columns carry
//    group -1 and rows without a group -2, so they never match.
//  - Register tiling and vector loads.  A thread owns kRows = 4 rows and reads
//    the staged columns from shared memory as 16-byte broadcasts (4 colours,
//    4 groups, 4 labels): three loads serve 16 pair tests, and the 16 tests
//    are independent, so the minimum chains do not stall the pipeline.
//  - Columns are split too.  A work item is (512 rows) x (256 columns) of one
//    batch row; partial minima meet in atomicMin, which has no order, so the
//    result does not depend on the split.  Rows and columns past the last
//    valid point of a batch row are never visited.
//  - The loop runs in one cooperative kernel (eps_components_kernel): blocks
//    draw work items from a counter, sweep in place (a row's proposal is also
//    hooked onto the row's current root, as in Shiloach-Vishkin), meet at a
//    grid barrier, chase every label to its root, meet again, and stop when no
//    batch row changed.  A batch row that did not change in a round is skipped
//    by every later round.  A tile of columns whose colour box lies farther
//    than eps from the row tile's box holds no edge and is skipped.  The host
//    launches once and reads the labels; there is no per-round synchronisation
//    and no other kernel between sweeps.  Labels only ever decrease to the
//    index of a point of the same component, and a round without a change is
//    a fixed point of every edge, so the labels are each component's least
//    index whatever the order of the updates.

#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 4;                    // rows (points i) per thread
constexpr int kRowTile = kThreads * kRows;  // 512 rows per work item
constexpr int kColTile = 256;               // columns per work item
constexpr int kPackThreads = 256;
static_assert(kRowTile == 2 * kColTile, "a row tile is two column tiles");

struct __align__(16) ColTile {
  uint32_t pc[kColTile];
  int32_t g[kColTile];
  int32_t l[kColTile];
};

// Per batch row, in `meta`: [0] floor(eps2) as int (-1: no edge at all),
// [1] rows to visit (1 + last index with a group >= 0), [2] columns to visit
// (1 + last valid index with a group >= 0), [3] the last round that changed
// the row (-1 before the first).  After the 4 * batch row entries: two work
// counters and the bad-input flag.
__device__ __forceinline__ int32_t* meta_row(int32_t* meta, int b) { return meta + 4 * b; }

__device__ __forceinline__ int32_t floor_eps2(float e2) {
  if (!(e2 >= 0.0f)) return -1;              // negative or NaN: d2 <= eps2 is never true
  return static_cast<int32_t>(floorf(fminf(e2, 3.0e5f)));  // d2 <= 3 * 255^2 < 3e5
}

// Pack one point: colour word, column group (folded with valid), the label or
// output fill, and the row's extents.  `points` (B, N, 3) f32, or, when it is
// null, `rows` (B, N) int32 packed colours with -1 for an absent point (group
// 0 for the present ones).  fill_labels: labels for the loop (own index where
// valid, else INT32_MAX); otherwise INT32_MAX everywhere (a sweep's output).
__global__ void eps_pack_kernel(const float* __restrict__ points,
                                const int32_t* __restrict__ rows,
                                const uint8_t* __restrict__ valid,
                                const int32_t* __restrict__ groups,
                                const float* __restrict__ eps2,
                                uint32_t* __restrict__ packed,
                                int32_t* __restrict__ gcol,
                                int32_t* __restrict__ fill, int fill_labels,
                                int32_t* __restrict__ meta, int batch, int n) {
  __shared__ int s_end[2];  // the block's row and column extents
  const int b = blockIdx.y;
  const int i = blockIdx.x * kPackThreads + threadIdx.x;
  int32_t* m = meta_row(meta, b);
  if (threadIdx.x < 2) s_end[threadIdx.x] = 0;
  if (i == 0) {
    m[0] = floor_eps2(eps2[b]);
    m[3] = -1;
  }
  __syncthreads();
  int row_end = 0, col_end = 0;
  if (i < n) {
    const size_t at = static_cast<size_t>(b) * n + i;
    uint32_t word;
    int32_t g_row, g_col;
    bool is_valid;
    if (points != nullptr) {
      const float x = points[at * 3 + 0], y = points[at * 3 + 1], z = points[at * 3 + 2];
      is_valid = valid[at] != 0;
      const bool in_range = x >= 0.0f && x <= 255.0f && y >= 0.0f && y <= 255.0f &&
                            z >= 0.0f && z <= 255.0f && x == floorf(x) &&
                            y == floorf(y) && z == floorf(z);
      if (!in_range) {
        if (is_valid || groups[at] >= 0) meta[4 * batch + 2] = 1;  // bad input
        word = 0u;
      } else {
        word = static_cast<uint32_t>(x) | (static_cast<uint32_t>(y) << 8) |
               (static_cast<uint32_t>(z) << 16);
      }
      g_row = groups[at];
      g_col = is_valid ? g_row : -1;
    } else {
      const int32_t r = rows[at];
      is_valid = r >= 0;
      if (r > 0xFFFFFF) meta[4 * batch + 2] = 1;
      word = is_valid ? static_cast<uint32_t>(r) & 0xFFFFFFu : 0u;
      g_row = g_col = is_valid ? 0 : -1;
    }
    packed[at] = word;
    gcol[at] = g_col;
    fill[at] = (fill_labels && is_valid) ? i : INT32_MAX;
    row_end = g_row >= 0 ? i + 1 : 0;
    col_end = g_col >= 0 ? i + 1 : 0;
  }
  // Row extents: reduce over the warp, then the block (which lies within one
  // batch row), so the row's two counters see one atomic per block each.
  row_end = __reduce_max_sync(0xFFFFFFFFu, row_end);
  col_end = __reduce_max_sync(0xFFFFFFFFu, col_end);
  if ((threadIdx.x & 31) == 0) {
    if (row_end > 0) atomicMax(&s_end[0], row_end);
    if (col_end > 0) atomicMax(&s_end[1], col_end);
  }
  __syncthreads();
  if (threadIdx.x < 2 && s_end[threadIdx.x] > 0) atomicMax(&m[1 + threadIdx.x], s_end[threadIdx.x]);
}

// One work item: rows [rt * 512, +512) against columns [ct * 256, +256) of one
// batch row.  Reads labels from `lab_in`, lowers `lab_out` with atomicMin
// (they may be the same array).  With `hook`, a lowered row also lowers the
// entry its old label points at.  Returns whether this thread lowered a label.
__device__ __forceinline__ bool sweep_item(const uint32_t* __restrict__ pc_b,
                                           const int32_t* __restrict__ rowg_b,
                                           const int32_t* __restrict__ colg_b,
                                           const int32_t* lab_in_b,
                                           int32_t* lab_out_b, bool hook,
                                           int32_t e2, int nrow, int ncol,
                                           int rt, int ct, ColTile& s) {
  const int tid = threadIdx.x;
  for (int t = tid; t < kColTile; t += kThreads) {
    const int j = ct * kColTile + t;
    const bool ok = j < ncol;
    s.pc[t] = ok ? pc_b[j] : 0u;
    s.g[t] = ok ? colg_b[j] : -1;
    s.l[t] = ok ? __ldcg(lab_in_b + j) : INT32_MAX;
  }
  uint32_t pr[kRows];
  int32_t gr[kRows], best[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = rt * kRowTile + r * kThreads + tid;
    const bool ok = i < nrow;
    pr[r] = ok ? pc_b[i] : 0u;
    const int32_t g = ok ? rowg_b[i] : -1;
    gr[r] = g < 0 ? -2 : g;
    best[r] = INT32_MAX;
  }
  __syncthreads();

  const int nv = (min(kColTile, ncol - ct * kColTile) + 3) >> 2;
  const uint4* pc4 = reinterpret_cast<const uint4*>(s.pc);
  const int4* g4 = reinterpret_cast<const int4*>(s.g);
  const int4* l4 = reinterpret_cast<const int4*>(s.l);
#define EPS_PAIR(C, G, L)                                              \
  {                                                                    \
    const uint32_t df = __vabsdiffu4(pr[r], (C));                      \
    const int32_t d2 = static_cast<int32_t>(__dp4a(df, df, 0u));       \
    best[r] = min(best[r], (d2 <= e2 && (G) == gr[r]) ? (L) : INT32_MAX); \
  }
#pragma unroll 2
  for (int v = 0; v < nv; ++v) {
    const uint4 c = pc4[v];
    const int4 g = g4[v];
    const int4 l = l4[v];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      EPS_PAIR(c.x, g.x, l.x)
      EPS_PAIR(c.y, g.y, l.y)
      EPS_PAIR(c.z, g.z, l.z)
      EPS_PAIR(c.w, g.w, l.w)
    }
  }
#undef EPS_PAIR

  bool lowered = false;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (best[r] == INT32_MAX) continue;
    const int i = rt * kRowTile + r * kThreads + tid;
    const int32_t cur = __ldcg(lab_out_b + i);
    if (best[r] < cur) {
      atomicMin(lab_out_b + i, best[r]);
      if (hook && cur != INT32_MAX) atomicMin(lab_out_b + cur, best[r]);
      lowered = true;
    }
  }
  return lowered;
}

// One out-of-place sweep: grid (column tiles, row tiles, batch).  `out` starts
// at INT32_MAX (eps_pack_kernel).
__global__ void __launch_bounds__(kThreads)
eps_sweep_kernel(const uint32_t* __restrict__ packed,
                 const int32_t* __restrict__ groups,
                 const int32_t* __restrict__ gcol,
                 const int32_t* __restrict__ labels, int32_t* out,
                 int32_t* meta, int n) {
  __shared__ ColTile s;
  const int b = blockIdx.z;
  const int32_t* m = meta_row(meta, b);
  const int nrow = m[1], ncol = m[2];
  if (blockIdx.y * kRowTile >= nrow || blockIdx.x * kColTile >= ncol) return;
  const size_t base = static_cast<size_t>(b) * n;
  sweep_item(packed + base, groups + base, gcol + base, labels + base,
             out + base, false, m[0], nrow, ncol, blockIdx.y, blockIdx.x, s);
}

// Squared distance between two colour boxes (lo, hi words of byte-wise
// minima and maxima); an empty box (lo = ~0, hi = 0) is far from every box.
__device__ __forceinline__ uint32_t box_gap2(uint2 a, uint2 b) {
  const uint32_t gap = __vsubus4(a.x, b.y) | __vsubus4(b.x, a.y);
  return __dp4a(gap, gap, 0u);
}

// The whole loop for a bucket of batch rows; cooperative launch, every block
// resident.  `lab` holds the labels (eps_pack_kernel's fill) and is updated in
// place; at the end invalid points get n.  `boxes` is (batch, column tiles).
__global__ void __launch_bounds__(kThreads)
eps_components_kernel(const uint32_t* __restrict__ packed,
                      const int32_t* __restrict__ gcol, int32_t* lab,
                      int32_t* meta, uint2* boxes, int batch, int n) {
  cg::grid_group grid = cg::this_grid();
  __shared__ ColTile s;
  __shared__ int s_item;

  const int tid = threadIdx.x;
  const int n_ct = (n + kColTile - 1) / kColTile;
  const int n_rt = (n + kRowTile - 1) / kRowTile;
  const int total = batch * n_rt * n_ct;
  int32_t* counters = meta + 4 * batch;
  const size_t cells = static_cast<size_t>(batch) * n;
  const size_t gtid = static_cast<size_t>(blockIdx.x) * kThreads + tid;
  const size_t gthreads = static_cast<size_t>(gridDim.x) * kThreads;

  // Colour box of every column tile: one warp per tile.
  {
    const int lane = tid & 31;
    const size_t n_warps = gthreads >> 5;
    for (size_t tile = gtid >> 5; tile < static_cast<size_t>(batch) * n_ct; tile += n_warps) {
      const int b = static_cast<int>(tile / n_ct), ct = static_cast<int>(tile % n_ct);
      uint32_t lo = 0xFFFFFFFFu, hi = 0u;
      for (int t = lane; t < kColTile; t += 32) {
        const int j = ct * kColTile + t;
        if (j < n && gcol[static_cast<size_t>(b) * n + j] >= 0) {
          const uint32_t p = packed[static_cast<size_t>(b) * n + j];
          lo = __vminu4(lo, p);
          hi = __vmaxu4(hi, p);
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        lo = __vminu4(lo, __shfl_xor_sync(0xFFFFFFFFu, lo, o));
        hi = __vmaxu4(hi, __shfl_xor_sync(0xFFFFFFFFu, hi, o));
      }
      if (lane == 0) boxes[tile] = make_uint2(lo, hi);
    }
  }
  grid.sync();

  for (int round = 0; round < n; ++round) {
    if (blockIdx.x == 0 && tid == 0) counters[(round + 1) & 1] = 0;
    // Sweep: draw work items until none is left.
    for (;;) {
      if (tid == 0) s_item = atomicAdd(&counters[round & 1], 1);
      __syncthreads();
      const int item = s_item;
      if (item >= total) break;
      const int ct = item % n_ct, rt = (item / n_ct) % n_rt, b = item / (n_ct * n_rt);
      int32_t* m = meta_row(meta, b);
      const int nrow = m[1], ncol = m[2];
      bool run = __ldcg(&m[3]) >= round - 1 && rt * kRowTile < nrow && ct * kColTile < ncol;
      if (run) {  // far-tile skip: no edge joins boxes farther apart than eps
        const uint2* bx = boxes + static_cast<size_t>(b) * n_ct;
        uint2 rbox = bx[2 * rt];
        if (2 * rt + 1 < n_ct) {
          const uint2 o = bx[2 * rt + 1];
          rbox = make_uint2(__vminu4(rbox.x, o.x), __vmaxu4(rbox.y, o.y));
        }
        run = static_cast<int32_t>(box_gap2(rbox, bx[ct])) <= m[0];
      }
      bool lowered = false;
      if (run) {
        const size_t base = static_cast<size_t>(b) * n;
        lowered = sweep_item(packed + base, gcol + base, gcol + base, lab + base,
                             lab + base, true, m[0], nrow, ncol, rt, ct, s);
      }
      if (__syncthreads_or(lowered) && tid == 0) m[3] = round;
    }
    grid.sync();
    // Chase every label of a row that is still moving to its root.
    for (size_t at = gtid; at < cells; at += gthreads) {
      const int b = static_cast<int>(at / n), i = static_cast<int>(at % n);
      const int32_t* m = meta_row(meta, b);
      if (__ldcg(&m[3]) < round || i >= m[1]) continue;
      int32_t* lab_b = lab + static_cast<size_t>(b) * n;
      const int32_t l = __ldcg(lab_b + i);
      if (l == INT32_MAX) continue;
      int32_t r = l;
      for (;;) {
        const int32_t p = __ldcg(lab_b + r);
        if (p >= r) break;
        r = p;
      }
      if (r < l) atomicMin(lab_b + i, r);
    }
    grid.sync();
    // Go on while some row changed in this round (>=: a block that is already
    // in the next round may have stamped a row with round + 1).
    bool any = false;
    for (int b = tid; b < batch; b += kThreads) any |= __ldcg(&meta_row(meta, b)[3]) >= round;
    if (!__syncthreads_or(any)) break;
  }

  for (size_t at = gtid; at < cells; at += gthreads)
    if (__ldcg(lab + at) == INT32_MAX) lab[at] = n;
}

int components_grid(int batch, int n, int* grid) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (rc == cudaSuccess && !coop) rc = cudaErrorNotSupported;
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, eps_components_kernel, kThreads, 0);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const long long items = static_cast<long long>(batch) * ((n + kRowTile - 1) / kRowTile) *
                          ((n + kColTile - 1) / kColTile);
  const long long fit = static_cast<long long>(sms) * min(per_sm, 8);
  *grid = static_cast<int>(max(1LL, min(items, fit)));
  return 0;
}

}  // namespace

extern "C" {

// Every tensor is contiguous on the device; every function launches on
// `stream` and returns a cudaError_t as an int (0 on success).

// points (B, N, 3) f32 with valid (B, N) uint8 and groups (B, N) int32, or
// points == null and rows (B, N) int32; eps2 (B,) f32.  Writes packed, gcol and
// fill (B, N) and meta (4 * B + 4 words, zeroed here first).
int eps_pack_launch(const float* points, const int32_t* rows, const uint8_t* valid,
                    const int32_t* groups, const float* eps2, uint32_t* packed,
                    int32_t* gcol, int32_t* fill, int fill_labels, int32_t* meta,
                    int batch, int n, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t rc = cudaMemsetAsync(meta, 0, (4 * static_cast<size_t>(batch) + 4) * sizeof(int32_t),
                                         static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  dim3 grid((n + kPackThreads - 1) / kPackThreads, batch);
  eps_pack_kernel<<<grid, kPackThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      points, rows, valid, groups, eps2, packed, gcol, fill, fill_labels, meta, batch, n);
  return static_cast<int>(cudaGetLastError());
}

// One sweep of packed rows: out (B, N) int32 must hold INT32_MAX.
int eps_sweep_launch(const uint32_t* packed, const int32_t* groups, const int32_t* gcol,
                     const int32_t* labels, int32_t* out, int32_t* meta, int batch,
                     int n, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((n + kColTile - 1) / kColTile, (n + kRowTile - 1) / kRowTile, batch);
  eps_sweep_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      packed, groups, gcol, labels, out, meta, n);
  return static_cast<int>(cudaGetLastError());
}

// The loop to convergence on packed rows; lab (B, N) int32 from the pack
// kernel, boxes 2 * B * ceil(N / 256) words of scratch.
int eps_components_launch(const uint32_t* packed, const int32_t* gcol, int32_t* lab,
                          int32_t* meta, void* boxes, int batch, int n, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  int grid = 0;
  const int rc = components_grid(batch, n, &grid);
  if (rc != 0) return rc;
  uint2* boxes2 = static_cast<uint2*>(boxes);
  void* args[] = {&packed, &gcol, &lab, &meta, &boxes2, &batch, &n};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(eps_components_kernel), dim3(grid), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
