// Masked per-segment float32 sums.
//
// Replaces the TPU kernel ndstpu/ops/segsum.py::_f32_kernel (reached
// through segment_sum_f32).  On the TPU the sums ran on the MXU as one-hot
// matrix products, tiled rows x segments, because the systolic array is the
// TPU's fast path for a reduction over a small key domain.  Hopper has no
// such constraint: this kernel is a scatter-add with float32 atomics.
//
// Contract (the TPU function's): rows with mask == 0 and rows whose gid is
// outside [0, s) add nothing; the result is float32 [s].  Float atomics add
// in no fixed order, so the sums agree with any other order only within a
// tolerance, not bit for bit.
//
// Bound: bytes.  The kernel must read 9 bytes a row (float32 value, int32
// gid, bool mask) and write 4 bytes a segment, at 3.35 TB/s on an H100
// SXM.  The design, by the regime of the caller's plan
// (ops/segsum.py::_plan_f32):
//   * rows are read 4 a thread as 16-byte vectors (a float4 of values, an
//     int4 of gids, the 4 mask bytes as one word) when the three base
//     pointers allow it after a scalar head of at most 3 rows; otherwise
//     one row a thread;
//   * SMEM (s <= 57,856): each block adds its rows into private
//     histograms in shared memory, as many copies as fit up to one a warp
//     (the plan's shared-memory bytes hold smem / (4 s) of them), so a hot
//     bin is contended by one warp, not 32; the grid fills the SMs and no
//     more.  Each block folds its copies, then the
//     CTAs of a thread-block cluster fold their histograms through
//     distributed shared memory, each CTA summing its share of the bins
//     across the cluster, and add every non-zero bin into the output with
//     one global atomic: one atomic a cluster a bin, not a block.
//   * GLOBAL (few rows a segment, or s above what shared memory holds):
//     rows add straight into the output with global atomics.  The lanes
//     of a warp that share a segment are grouped (__match_any_sync,
//     shuffles) so one leader a group adds: a hot segment costs one
//     atomic a warp, not one a row, on its one address.
//   * Float atomics on shared memory compile to a compare-and-swap loop on
//     sm_90, which spins on a contended bin; the copy a warp leaves each
//     bin one warp's worth of contention, and grouping there cost more
//     than it saved (PERF.md), so SMEM adds row by row.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC  (ndstpu_torch/ops/build.py)

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// A launch plan, as ops/segsum.py::Plan lays it out (outside the unnamed
// namespace: the C launcher takes it).
struct Plan {
  int regime, grid, block, cluster, smem;
};

namespace {

// dynamic shared memory a block may ask for: the 232,448 B a block can use
// on sm_90, less 1 KB
constexpr int kSmemDynMax = 232448 - 1024;

enum Regime { kGlobal = 0, kSmem = 1 };

constexpr unsigned kFull = 0xffffffffu;

// The lanes whose rows share this lane's segment (lanes that take no row
// get keys of their own: gids are below 2^31).
__device__ __forceinline__ unsigned peers_of(bool take, int g) {
  const unsigned own = 0x80000000u | (threadIdx.x & 31);
  return __match_any_sync(kFull, take ? (unsigned)g : own);
}

// Adds the rows of each group of `peers` with one atomic a group: a
// segmented sum by shuffles (log2 of the group's size rounds; none when no
// two lanes share a segment), then the lowest lane of the group adds.
__device__ __forceinline__ void add_grouped(float* sink, unsigned peers,
                                            bool take, int g, float v) {
  const int lane = threadIdx.x & 31;
  float x = take ? v : 0.f;
  const int rank = __popc(peers & ((1u << lane) - 1u));
  int pos = rank;
  unsigned rest = peers & ~((2u << lane) - 1u);
  while (__any_sync(kFull, rest != 0)) {
    const int next = __ffs(rest);
    const float t = __shfl_sync(kFull, x, next ? next - 1 : lane);
    if (next) x += t;
    rest &= ~__ballot_sync(kFull, pos & 1);
    pos >>= 1;
  }
  if (take && rank == 0) atomicAdd(&sink[g], x);
}

// Adds K row slots, one row a lane each; every lane of the warp calls this
// together.  Into global memory the lanes that share a segment are
// grouped; into a shared histogram copy each row adds on its own.
template <int R, int K>
__device__ __forceinline__ void add_rows(float* sink, const bool (&take)[K],
                                         const int (&g)[K],
                                         const float (&v)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (R == kGlobal)
      add_grouped(sink, peers_of(take[k], g[k]), take[k], g[k], v[k]);
    else if (take[k])
      atomicAdd(&sink[g[k]], v[k]);
  }
}

template <int R, int VEC>
__global__ void __launch_bounds__(1024)
    segsum_f32_kernel(const float* __restrict__ vals,
                      const int* __restrict__ gid,
                      const unsigned char* __restrict__ mask, long long n,
                      int num_segments, int head, int reps,
                      float* __restrict__ out) {
  // `reps` copies of the histogram; warp w adds into copy w % reps
  extern __shared__ __align__(16) float hist[];
  const int s = num_segments;
  if (R != kGlobal) {
    for (int j = threadIdx.x; j < reps * s; j += blockDim.x) hist[j] = 0.f;
    __syncthreads();
  }
  float* const sink =
      R == kGlobal ? out : hist + (threadIdx.x / 32 % reps) * s;
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first =
      (long long)blockIdx.x * blockDim.x + threadIdx.x - lane;
  // rows [head, head + VEC * nv) as vectors; the rest one by one below
  const long long nv = VEC == 1 ? n : (n - head) / VEC;
  for (long long base = first; base < nv; base += stride) {
    const long long u = base + lane;
    float v[VEC] = {};
    int g[VEC] = {};
    unsigned m = 0;
    if (u < nv) {
      if constexpr (VEC == 4) {
        const long long r0 = head + 4 * u;
        const float4 a = *reinterpret_cast<const float4*>(vals + r0);
        const int4 b = *reinterpret_cast<const int4*>(gid + r0);
        m = *reinterpret_cast<const unsigned*>(mask + r0);
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        g[0] = b.x; g[1] = b.y; g[2] = b.z; g[3] = b.w;
      } else {
        v[0] = vals[u];
        g[0] = gid[u];
        m = mask[u];
      }
    }
    bool take[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      take[k] = ((m >> (8 * k)) & 0xffu) && (unsigned)g[k] < (unsigned)s;
    add_rows<R, VEC>(sink, take, g, v);
  }
  if (VEC != 1 && blockIdx.x == 0 && threadIdx.x < 32) {
    // the scalar head (lanes 0..head-1) and tail (lanes 8..) of the rows
    const long long tail0 = head + VEC * nv;
    long long r = -1;
    if (lane < head) r = lane;
    if (lane >= 8 && tail0 + (lane - 8) < n) r = tail0 + (lane - 8);
    const bool in = r >= 0 && mask[r];
    const int g[1] = {r >= 0 ? gid[r] : 0};
    const float v[1] = {r >= 0 ? vals[r] : 0.f};
    const bool take[1] = {in && (unsigned)g[0] < (unsigned)s};
    add_rows<R, 1>(sink, take, g, v);
  }
  if (R == kGlobal) return;

  // fold the copies into the first
  __syncthreads();
  if (reps > 1) {
    for (int j = threadIdx.x; j < s; j += blockDim.x) {
      float t = hist[j];
      for (int r = 1; r < reps; ++r) t += hist[r * s + j];
      hist[j] = t;
    }
    __syncthreads();
  }
  // fold the cluster's histograms: CTA r sums bins [r * chunk, +chunk)
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int size = (int)cluster.num_blocks();
  const int chunk = (s + size - 1) / size;
  const int lo = (int)cluster.block_rank() * chunk;
  const int hi = lo + chunk < s ? lo + chunk : s;
  for (int j = lo + threadIdx.x; j < hi; j += blockDim.x) {
    float t = 0.f;
    for (int q = 0; q < size; ++q) t += cluster.map_shared_rank(hist, q)[j];
    if (t != 0.f) atomicAdd(&out[j], t);
  }
  // no CTA leaves while another may still read its histogram
  cluster.sync();
}

template <int R, int VEC>
cudaError_t launch(const float* v, const int* g, const unsigned char* m,
                   long long n, int s, int head, float* out, int grid,
                   int block, int cluster, int smem, cudaStream_t st) {
  const int reps = R == kGlobal ? 1 : smem / (4 * s);
  auto kernel = segsum_f32_kernel<R, VEC>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, v, g, m, n, s, head, reps, out);
}

template <int R>
cudaError_t launch_vec(const void* vals, const void* gid, const void* mask,
                       long long n, int s, float* out, const Plan& p,
                       cudaStream_t st) {
  const float* v = static_cast<const float*>(vals);
  const int* g = static_cast<const int*>(gid);
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  // the first row at which all three pointers allow 16-byte vectors
  for (int h = 0; h < 4 && h < n; ++h)
    if (((uintptr_t)(v + h)) % 16 == 0 && ((uintptr_t)(g + h)) % 16 == 0 &&
        ((uintptr_t)(m + h)) % 4 == 0)
      return launch<R, 4>(v, g, m, n, s, h, out, p.grid, p.block, p.cluster,
                          p.smem, st);
  return launch<R, 1>(v, g, m, n, s, 0, out, p.grid, p.block, p.cluster,
                      p.smem, st);
}

// The opt-in above 48 KB of dynamic shared memory (static shared memory
// counts against the 48 KB too) for one shared-memory instantiation, on
// the current device.
template <int VEC>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(segsum_f32_kernel<kSmem, VEC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemDynMax);
}

}  // namespace

// Prepares the current device for the launcher: the shared-memory opt-in
// of every instantiation that uses shared memory.  Called once a device
// before the first launch; returns the first CUDA error, or 0.
extern "C" int segsum_f32_prepare() {
  const cudaError_t err = allow_smem<1>();
  return (int)(err != cudaSuccess ? err : allow_smem<4>());
}

// Zeroes `out` (float32 [num_segments]) on `stream` and, when
// plan->grid > 0, launches the kernel once with the caller's plan
// (ops/segsum.py::Plan): regime (0 global, 1 shared memory with a cluster
// fold), grid, block, cluster and dynamic shared-memory bytes.  Returns
// the first CUDA error, or 0.
extern "C" int segsum_f32_launch(const void* vals, const void* gid,
                                 const void* mask, long long n,
                                 int num_segments, void* out,
                                 const Plan* plan, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const int s = num_segments;
  cudaError_t err = cudaMemsetAsync(o, 0, (size_t)s * sizeof(float), st);
  if (err != cudaSuccess || plan->grid <= 0) return (int)err;
  if (plan->regime == kGlobal)
    err = launch_vec<kGlobal>(vals, gid, mask, n, s, o, *plan, st);
  else if (plan->regime == kSmem)
    err = launch_vec<kSmem>(vals, gid, mask, n, s, o, *plan, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
