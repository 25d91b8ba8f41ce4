// k-means++ initial centres: every step of every row's seeding in one launch.
//
// Replaces no TPU kernel.  The JAX package seeds k-means++ inside its jitted
// k-means (its ops/cluster.py `kmeans`: a `fori_loop` of
// jax.random.categorical draws), which XLA compiles to device code; the port
// seeded in a Python loop of about 20 small PyTorch launches a centre
// (ops/cluster.py `_plusplus_loop`, the plain version of this kernel, which
// the CPU still runs).  This kernel computes the same centres bit for bit.
//
// What it computes, for each row (points (m, 3), valid (m,), k, the shared
// noise rows g_i (n_draws, m) and the float32 log table of squared
// distances):
//   step 0:  c_0 = points[argmax(valid ? g_0 : -inf)];
//            d2 = valid ? |p - c_0|^2 : (not valid);
//   step i < min(k, n_draws, k_max):
//            logit = valid && d2 > 0 ? log_table[d2] : -inf;
//            if no logit is finite, logit = valid ? 0 : -inf;
//            c_i = points[argmax(g_i + logit)]  (ties to the least index);
//            d2 = min(d2, |p - c_i|^2);
//   centres past the row's last step are 0.
// Colours are integers in [0, 255], so every d2 is an exact integer in any
// order of the three squares (here ((dx^2 + dy^2) + dz^2), each operation
// rounded on its own, as __fmul_rn / __fadd_rn write it), and the logit is a
// gather from the same table the plain version reads.  The one rounding left
// is g + logit, one float32 add.  The "no finite logit" fallback is the
// second of two candidates carried through the same reduction: (best g +
// logit over live points, index) and (best g over valid points, index); the
// first wins whenever a row has a live point.
//
// What bounds it on an H100: latency, not bytes or operations.  A step is a
// dependent chain (the argmax decides the centre that the next step's
// distances need), so a seeding is n_draws barriers in a row; its work, about
// 12 float operations a point and step, and its bytes (the points once, each
// noise row once) take a few microseconds at the cells' sizes.
//
// What the design does about it: one thread-block cluster a row, each block
// keeping its slice of the row's points, distances and logits in shared
// memory for every step.  A step is one pass over the slice (the distance to
// the last centre, the logit gathered only where the distance fell, both
// candidates), a warp-shuffle argmax, a block argmax in shared memory, and a
// cluster-wide argmax over distributed shared memory behind one cluster
// barrier; each block's candidate slot is double-buffered by step, so one
// barrier a step suffices.  Any block then reads the winning point from
// global memory (an L2 hit).  The next step's noise is loaded before the
// barrier.  The wrapper chooses the cluster from the row's width: one block
// a row for narrow rows (the split buckets, many rows of 64-4,096 points), up
// to 16 blocks (a non-portable cluster size) for wide ones; a slice too long
// for shared memory lives in a global scratch buffer instead (the same code
// through a generic pointer), so any m below 2^31 is taken.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kPre = 8;              // noise values a thread loads ahead of its step
constexpr int kNone = 0x7FFFFFFF;    // no index yet: loses every tie
constexpr int kOnChip = 10240;       // points a block keeps in shared memory (ops/cuda/kmeanspp.py)
constexpr int kMaxSmem = kOnChip * 5 * static_cast<int>(sizeof(float));

struct Best {
  float v;
  int j;
};

__device__ __forceinline__ void take(Best& b, float v, int j) {
  if (v > b.v || (v == b.v && j < b.j)) {
    b.v = v;
    b.j = j;
  }
}

// Every lane ends with the warp's best: the order is total, so the
// butterfly's order of combination does not matter.
__device__ __forceinline__ void warp_best(Best& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_xor_sync(0xFFFFFFFFu, b.v, off);
    const int j = __shfl_xor_sync(0xFFFFFFFFu, b.j, off);
    take(b, v, j);
  }
}

// Grid: cluster * B blocks, block r of row `row` at cluster * row + r, owning
// points [r * slice, (r + 1) * slice) of the row.  `scratch` is null when the
// slices live in dynamic shared memory (5 * slice floats), else 5 * slice
// floats per block in global memory.
__global__ void __launch_bounds__(kMaxThreads, 1)
kmeanspp_kernel(const float* __restrict__ points, const uint8_t* __restrict__ valid,
                const long long* __restrict__ ks, const float* __restrict__ noise,
                const float* __restrict__ log_table, int table_len, float* __restrict__ centers,
                float* scratch, int m, int n_draws, int k_max, int cluster, int slice) {
  extern __shared__ float dyn[];
  __shared__ Best warp_live[32], warp_fb[32];
  __shared__ float4 slot[2];

  const float inf = __int_as_float(0x7F800000);
  const int rank = static_cast<int>(blockIdx.x) % cluster;
  const int row = static_cast<int>(blockIdx.x) / cluster;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const long long lo_ll = static_cast<long long>(rank) * slice;
  const int lo = static_cast<int>(lo_ll < m ? lo_ll : m);
  const int n_loc = static_cast<int>(lo_ll < m ? min(static_cast<long long>(slice), m - lo_ll) : 0);

  float* st = scratch != nullptr ? scratch + static_cast<size_t>(blockIdx.x) * 5 * slice : dyn;
  float* px = st;
  float* py = st + static_cast<size_t>(slice);
  float* pz = st + static_cast<size_t>(slice) * 2;
  float* d2 = st + static_cast<size_t>(slice) * 3;   // -1: not valid; +inf: no centre yet
  float* lg = st + static_cast<size_t>(slice) * 4;   // log_table[d2], set when d2 falls

  // Each thread touches only its own points l = tid + q * nthreads, here and
  // in every step, so the slice needs no barrier.
  const size_t rbase = static_cast<size_t>(row) * m;
  for (int l = tid; l < n_loc; l += nthreads) {
    const float* p = points + (rbase + lo + l) * 3;
    px[l] = p[0];
    py[l] = p[1];
    pz[l] = p[2];
    d2[l] = valid[rbase + lo + l] ? inf : -1.0f;
  }

  const long long kr = ks[row];
  const int n_steps = static_cast<int>(max(1LL, min(kr, static_cast<long long>(min(n_draws, k_max)))));
  float g_next[kPre];
  auto load_noise = [&](int step) {
    const float* gr = noise + static_cast<size_t>(step) * m + lo;
#pragma unroll
    for (int q = 0; q < kPre; ++q) {
      const int l = tid + q * nthreads;
      g_next[q] = l < n_loc ? __ldg(gr + l) : 0.0f;
    }
  };
  load_noise(0);
  float cx = 0.0f, cy = 0.0f, cz = 0.0f;  // the last step's centre

  for (int i = 0; i < n_steps; ++i) {
    Best live{-inf, kNone}, fb{-inf, kNone};
    auto visit = [&](int l, float g) {
      float d = d2[l];
      if (d < 0.0f) {  // not valid: -inf in both candidates
        take(fb, -inf, lo + l);
        return;
      }
      if (i > 0) {
        const float dx = __fsub_rn(px[l], cx), dy = __fsub_rn(py[l], cy), dz = __fsub_rn(pz[l], cz);
        const float nd = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        if (nd < d) {
          d = nd;
          d2[l] = nd;
          lg[l] = nd > 0.0f ? __ldg(log_table + min(static_cast<int>(nd), table_len - 1)) : -inf;
        }
      }
      take(fb, g, lo + l);
      if (i > 0 && d > 0.0f) take(live, __fadd_rn(g, lg[l]), lo + l);
    };
#pragma unroll
    for (int q = 0; q < kPre; ++q) {
      const int l = tid + q * nthreads;
      if (l < n_loc) visit(l, g_next[q]);
    }
    const float* gr = noise + static_cast<size_t>(i) * m + lo;
    for (int l = tid + kPre * nthreads; l < n_loc; l += nthreads) visit(l, __ldg(gr + l));
    if (i + 1 < n_steps) load_noise(i + 1);

    // Warp, block, then cluster.  warp_* are next written after this
    // step's barrier, which warp 0 passes only after reading them; slot[i & 1]
    // is next written two steps on, after the next step's barrier, which
    // every block passes only after reading this one.
    warp_best(live);
    warp_best(fb);
    if (lane == 0) {
      warp_live[warp] = live;
      warp_fb[warp] = fb;
    }
    __syncthreads();
    if (warp == 0) {
      Best a{-inf, kNone}, f{-inf, kNone};
      if (lane < nwarps) {
        a = warp_live[lane];
        f = warp_fb[lane];
      }
      warp_best(a);
      warp_best(f);
      if (lane == 0) slot[i & 1] = make_float4(a.v, __int_as_float(a.j), f.v, __int_as_float(f.j));
    }
    float4 s;
    if (cluster > 1) {
      cg::cluster_group cl = cg::this_cluster();
      cl.sync();
      s = lane < cluster ? *cl.map_shared_rank(&slot[i & 1], lane)
                         : make_float4(-inf, __int_as_float(kNone), -inf, __int_as_float(kNone));
    } else {
      __syncthreads();
      s = slot[i & 1];
    }
    Best a{s.x, __float_as_int(s.y)}, f{s.z, __float_as_int(s.w)};
    if (cluster > 1) {
      warp_best(a);
      warp_best(f);
    }
    const int idx = a.j != kNone ? a.j : f.j;
    const float* w = points + (rbase + idx) * 3;
    cx = __ldg(w);
    cy = __ldg(w + 1);
    cz = __ldg(w + 2);
    if (rank == 0 && tid == 0) {
      float* c = centers + (static_cast<size_t>(row) * k_max + i) * 3;
      c[0] = cx;
      c[1] = cy;
      c[2] = cz;
    }
  }

  if (rank == 0) {
    float* c = centers + static_cast<size_t>(row) * k_max * 3;
    for (int e = n_steps * 3 + tid; e < k_max * 3; e += nthreads) c[e] = 0.0f;
  }
  // No block may leave while another can still read its slot.
  if (cluster > 1) cg::this_cluster().sync();
}

// Always the same largest shared memory, so launches of other sizes from
// several host threads never race on the attribute.
cudaError_t set_attributes(int cluster) {
  cudaError_t e = cudaFuncSetAttribute(kmeanspp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == cudaSuccess && cluster > 8)
    e = cudaFuncSetAttribute(kmeanspp_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

}  // namespace

extern "C" {

// points (b, m, 3) float32, valid (b, m) uint8, ks (b,) int64, noise
// (n_draws, m) float32, log_table (table_len,) float32, centers (b, k_max, 3)
// float32 written whole; scratch null (slices in shared memory) or 5 * slice
// floats per block.  Launches cluster * b blocks of `threads` on `stream`;
// returns the launch's error or cudaGetLastError().
int kmeanspp_launch(const float* points, const uint8_t* valid, const long long* ks, const float* noise,
                    const float* log_table, int table_len, float* centers, float* scratch, int b, int m,
                    int n_draws, int k_max, int cluster, int threads, int slice, void* stream) {
  if (b <= 0 || m <= 0) return 0;
  if (cluster < 1 || cluster > 16 || threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      static_cast<long long>(cluster) * slice < m || static_cast<long long>(cluster) * b > 0x7FFFFFFFLL ||
      (scratch == nullptr && slice > kOnChip))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = scratch != nullptr ? 0 : static_cast<size_t>(slice) * 5 * sizeof(float);
  cudaError_t e = set_attributes(cluster);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * b);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kmeanspp_kernel, points, valid, ks, noise, log_table, table_len, centers,
                         scratch, m, n_draws, k_max, cluster, slice);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
