// Exact masked per-segment int64 sums and row counts for scaled decimals.
//
// Replaces the TPU kernel ndstpu/ops/segsum.py::_limb_kernel (reached
// through segment_sum_decimal).  On the TPU the sums ran on the MXU as
// one-hot matrix products over 8-bit limb planes, because the TPU has no
// native 64-bit integer adder.  Hopper adds 64-bit integers natively, so
// this kernel is a scatter-add; integer addition modulo 2^64 is
// order-free, so every privatisation below stays bit-exact.
//
// Contract, kept bit-exact against the TPU function:
//   * rows with mask == 0, and rows whose gid is outside [0, s), add nothing;
//   * a row's count follows the TPU count plane (v + 2^41) != 0;
//   * if any masked-in |v| >= 2^41 (gid in range or not), every sum is -2^62.
// The one deliberate difference: the TPU function refuses more than
// (2^31 - 1) / 255 rows, because its limb accumulators are int32.  Here
// everything accumulates in 64 bits and that row limit is lifted.
//
// Bound: bytes.  The kernel must read 13 bytes a row (int64 value, int32
// gid, bool mask) and write 16 bytes a segment, at 3.35 TB/s on an H100
// SXM.  What keeps a scatter from that bound is its atomics, and the
// design answers them in two ways.
//   * Where rows add (the regime of the caller's plan,
//     ops/segsum.py::_plan_decimal, by rows a segment and by segments):
//     - GLOBAL, few rows a segment: straight into device memory;
//     - SMEM, many rows a segment and s <= 19,285: a histogram privatised
//       per block in shared memory (64-bit sums, 32-bit counts, 12 B a
//       segment), flushed once a block with one global atomic per
//       non-empty bin.  A 64-bit sum adds as two native 32-bit shared
//       atomics with a carry: sm_90 has no native 64-bit shared atomic
//       add, and the compare-and-swap loop it compiles to spins on a hot
//       bin;
//     - CLUSTER, many rows a segment and s up to 38,570 (the engine's gate
//       is 32,768): the histogram split across a thread-block cluster of
//       2, each CTA owning half of the segments; rows add into the
//       owner's shared memory through distributed shared memory, with the
//       same two 32-bit atomics as the owner's own adds, so every atomic
//       on a bin covers the same four bytes (atomics of different sizes
//       on one location are not ordered by the memory model).
//   * How many atomics a hot segment costs: the lanes of a warp that
//     share a segment are grouped by __match_any_sync and summed by
//     shuffles, and one leader a group adds the group's sum and count:
//     one atomic a warp, not one a row.  Grouping every row costs more
//     than it saves on spread-out segments, so a warp samples: it groups
//     the four row slots of a step only when the first shows a segment
//     holding 4 or more of its 32 rows (PERF.md has both other choices'
//     times).
// Rows are read 4 a thread as 16-byte vectors (two longlong2, an int4 of
// gids, the 4 mask bytes as one word) when the three base pointers allow
// it after a scalar head of at most 3 rows; otherwise one row a thread.
//
// One launch a call: the caller passes one int64 buffer [2, s] (sums,
// counts), which the launcher zeroes with one cudaMemsetAsync, and two
// int64 words of its stream (an out-of-range flag and a block ticket
// counter), zero before the launch.  Each block ends by taking a ticket;
// the block that takes the last one writes -2^62 into every sum when the
// flag is set, and sets both words back to zero for the stream's next
// call.
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

constexpr long long kBias = 1LL << 41;
constexpr long long kPoison = -(1LL << 62);
constexpr unsigned kFull = 0xffffffffu;
// dynamic shared memory a block may ask for: the 232,448 B a block can use
// on sm_90, less 1 KB for the kernel's static shared memory
constexpr int kSmemDynMax = 232448 - 1024;

enum Regime { kGlobal = 0, kSmem = 1, kCluster = 2 };

typedef unsigned long long u64;

// Adds a 64-bit value into a shared-memory bin, this CTA's or (through
// distributed shared memory) its cluster peer's, with two native 32-bit
// atomics (a 64-bit atomicAdd on shared memory compiles to a
// compare-and-swap loop, which spins on a hot bin): the low word returns
// its old value, which gives the carry into the high word.  Exact modulo
// 2^64 in any order.  Every atomic on a bin goes through here.
__device__ __forceinline__ void shared_add64(u64* p, u64 v) {
  unsigned* w = reinterpret_cast<unsigned*>(p);
  const unsigned lo = (unsigned)v;
  const unsigned hi = (unsigned)(v >> 32) + (atomicAdd(&w[0], lo) + lo < lo);
  if (hi) atomicAdd(&w[1], hi);
}

// Where a row's (sum, count) goes.
template <int R>
struct Sink;

template <>
struct Sink<kGlobal> {
  u64* sums;
  u64* counts;
  __device__ void init(u64* s, u64* c, int, void*) { sums = s; counts = c; }
  __device__ __forceinline__ void add(int g, u64 v, unsigned c) const {
    atomicAdd(&sums[g], v);
    if (c) atomicAdd(&counts[g], (u64)c);
  }
};

template <>
struct Sink<kSmem> {
  u64* hs;
  unsigned* hc;
  __device__ void init(u64*, u64*, int bins, void* smem) {
    hs = static_cast<u64*>(smem);
    hc = reinterpret_cast<unsigned*>(hs + bins);
  }
  __device__ __forceinline__ void add(int g, u64 v, unsigned c) const {
    shared_add64(&hs[g], v);
    if (c) atomicAdd(&hc[g], c);
  }
};

template <>
struct Sink<kCluster> {
  // CTA r owns segments [r * half, r * half + half): its own half adds
  // into its shared memory, the other CTA's through distributed shared
  // memory, both by shared_add64's 32-bit halves
  u64* own_s;
  unsigned* own_c;
  u64* other_s;
  unsigned* other_c;
  int half;
  int rank;
  __device__ void init(u64*, u64*, int bins, void* smem) {
    cg::cluster_group cluster = cg::this_cluster();
    half = bins;
    rank = (int)cluster.block_rank();
    own_s = static_cast<u64*>(smem);
    own_c = reinterpret_cast<unsigned*>(own_s + bins);
    other_s = cluster.map_shared_rank(own_s, rank ^ 1);
    other_c = reinterpret_cast<unsigned*>(other_s + bins);
  }
  __device__ __forceinline__ void add(int g, u64 v, unsigned c) const {
    const int r = g >= half;
    const int j = g - r * half;
    if (r == rank) {
      shared_add64(&own_s[j], v);
      if (c) atomicAdd(&own_c[j], c);
    } else {
      shared_add64(&other_s[j], v);
      if (c) atomicAdd(&other_c[j], c);
    }
  }
};

// A segment that holds this many of a warp's 32 rows on the sampled row
// slot makes the warp group its rows.
constexpr int kHotLanes = 4;

// The lanes whose rows share this lane's segment (lanes that take no row
// get keys of their own: gids are below 2^31).
__device__ __forceinline__ unsigned peers_of(bool take, int g) {
  const unsigned own = 0x80000000u | (threadIdx.x & 31);
  return __match_any_sync(kFull, take ? (unsigned)g : own);
}

// Adds the rows of each group of `peers` with one atomic a group: a
// segmented sum by shuffles (log2 of the group's size rounds; none when no
// two lanes share a segment), then the lowest lane of the group adds.
template <int R>
__device__ __forceinline__ void add_grouped(const Sink<R>& sink,
                                            unsigned peers, bool take, int g,
                                            long long v) {
  const int lane = threadIdx.x & 31;
  const unsigned counting = __ballot_sync(kFull, take && v != -kBias);
  u64 x = take ? (u64)v : 0ULL;
  const int rank = __popc(peers & ((1u << lane) - 1u));
  int pos = rank;
  unsigned rest = peers & ~((2u << lane) - 1u);
  while (__any_sync(kFull, rest != 0)) {
    const int next = __ffs(rest);
    const u64 t = __shfl_sync(kFull, x, next ? next - 1 : lane);
    if (next) x += t;
    rest &= ~__ballot_sync(kFull, pos & 1);
    pos >>= 1;
  }
  if (take && rank == 0) sink.add(g, x, __popc(peers & counting));
}

// Adds K row slots, one row a lane each; every lane of the warp calls this
// together.  All K slots are grouped when the first shows a hot segment
// (kHotLanes or more lanes), else added row by row.
template <int R, int K>
__device__ __forceinline__ void add_rows(const Sink<R>& sink,
                                         const bool (&take)[K],
                                         const int (&g)[K],
                                         const long long (&v)[K]) {
  const unsigned first = peers_of(take[0], g[0]);
  const bool grouped = __any_sync(kFull, __popc(first) >= kHotLanes);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (grouped)
      add_grouped(sink, k == 0 ? first : peers_of(take[k], g[k]), take[k],
                  g[k], v[k]);
    else if (take[k])
      sink.add(g[k], (u64)v[k], v[k] != -kBias);
  }
}

template <int R, int VEC>
__global__ void __launch_bounds__(1024)
    segsum_decimal_kernel(const long long* __restrict__ vals,
                          const int* __restrict__ gid,
                          const unsigned char* __restrict__ mask, long long n,
                          int num_segments, int head, u64* __restrict__ buf,
                          u64* __restrict__ aux) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  u64* sums = buf;
  u64* counts = buf + num_segments;
  u64* flag = aux;
  u64* tickets = aux + 1;

  // shared bins this CTA owns
  const int bins = R == kCluster ? (num_segments + 1) / 2
                   : R == kSmem  ? num_segments
                                 : 0;
  Sink<R> sink;
  sink.init(sums, counts, bins, smem);
  if (R != kGlobal) {
    u64* hs = reinterpret_cast<u64*>(smem);
    unsigned* hc = reinterpret_cast<unsigned*>(hs + bins);
    for (int j = threadIdx.x; j < bins; j += blockDim.x) {
      hs[j] = 0;
      hc[j] = 0;
    }
  }
  if (R == kCluster)
    cg::this_cluster().sync();
  else
    __syncthreads();

  bool oob = false;
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first =
      (long long)blockIdx.x * blockDim.x + threadIdx.x - lane;
  // rows [head, head + VEC * nv) as vectors; the rest one by one below
  const long long nv = VEC == 1 ? n : (n - head) / VEC;
  for (long long base = first; base < nv; base += stride) {
    const long long u = base + lane;
    const bool live = u < nv;
    long long v[VEC] = {};
    int g[VEC] = {};
    unsigned m = 0;
    if constexpr (VEC == 4) {
      if (live) {
        const long long r0 = head + 4 * u;
        const longlong2 a = *reinterpret_cast<const longlong2*>(vals + r0);
        const longlong2 b = *reinterpret_cast<const longlong2*>(vals + r0 + 2);
        const int4 gg = *reinterpret_cast<const int4*>(gid + r0);
        m = *reinterpret_cast<const unsigned*>(mask + r0);
        v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
        g[0] = gg.x; g[1] = gg.y; g[2] = gg.z; g[3] = gg.w;
      }
    } else if (live) {
      v[0] = vals[u];
      g[0] = gid[u];
      m = mask[u];
    }
    bool take[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const bool in = (m >> (8 * k)) & 0xffu;
      take[k] = in && g[k] >= 0 && g[k] < num_segments;
      if (in) oob |= v[k] <= -kBias || v[k] >= kBias;
    }
    add_rows<R, VEC>(sink, take, g, v);
  }
  if (VEC != 1 && blockIdx.x == 0 && threadIdx.x < 32) {
    // the scalar head (lanes 0..head-1) and tail (lanes 8..) of the rows
    const long long tail0 = head + VEC * nv;
    long long r = -1;
    if (lane < head) r = lane;
    if (lane >= 8 && tail0 + (lane - 8) < n) r = tail0 + (lane - 8);
    const bool in = r >= 0 && mask[r];
    const long long vv[1] = {r >= 0 ? vals[r] : 0};
    const int gg[1] = {r >= 0 ? gid[r] : -1};
    const bool take[1] = {in && gg[0] >= 0 && gg[0] < num_segments};
    if (in) oob |= vv[0] <= -kBias || vv[0] >= kBias;
    add_rows<R, 1>(sink, take, gg, vv);
  }

  if (R == kCluster)
    cg::this_cluster().sync();
  else
    __syncthreads();
  if (R != kGlobal) {
    // flush the bins this CTA owns: one global atomic per non-empty bin
    const u64* hs = reinterpret_cast<const u64*>(smem);
    const unsigned* hc = reinterpret_cast<const unsigned*>(hs + bins);
    const int off = R == kCluster ? (int)cg::this_cluster().block_rank() * bins
                                  : 0;
    for (int j = threadIdx.x; j < bins && off + j < num_segments;
         j += blockDim.x) {
      const u64 s = hs[j];
      const unsigned c = hc[j];
      if (s) atomicAdd(&sums[off + j], s);
      if (c) atomicAdd(&counts[off + j], (u64)c);
    }
  }

  // the last block to finish poisons every sum if a value was out of range
  const int any_oob = __syncthreads_or(oob);
  if (threadIdx.x == 0 && any_oob) atomicOr(flag, 1ULL);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const u64 t = atomicAdd(tickets, 1ULL);
    s_last = t == gridDim.x - 1 ? 1 : 0;
    if (s_last) {
      __threadfence();
      s_last += atomicAdd(flag, 0ULL) != 0;
      // every other block is done with both words: ready for the next call
      *flag = 0;
      *tickets = 0;
    }
  }
  __syncthreads();
  if (s_last == 2)
    for (int j = threadIdx.x; j < num_segments; j += blockDim.x)
      sums[j] = (u64)kPoison;
}

template <int R, int VEC>
cudaError_t launch(const void* vals, const void* gid, const void* mask,
                   long long n, int s, int head, void* buf, void* aux,
                   int grid, int block, int cluster, int smem,
                   cudaStream_t st) {
  auto kernel = segsum_decimal_kernel<R, VEC>;
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
  return cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const long long*>(vals),
      static_cast<const int*>(gid), static_cast<const unsigned char*>(mask), n,
      s, head, static_cast<u64*>(buf), static_cast<u64*>(aux));
}

template <int R>
cudaError_t launch_vec(const void* vals, const void* gid, const void* mask,
                       long long n, int s, void* buf, void* aux,
                       const Plan& p, cudaStream_t st) {
  // the first row at which all three pointers allow 16-byte vectors
  const uintptr_t pv = (uintptr_t)vals, pg = (uintptr_t)gid,
                  pm = (uintptr_t)mask;
  for (int h = 0; h < 4 && h < n; ++h)
    if ((pv + 8 * h) % 16 == 0 && (pg + 4 * h) % 16 == 0 && (pm + h) % 4 == 0)
      return launch<R, 4>(vals, gid, mask, n, s, h, buf, aux, p.grid, p.block,
                          p.cluster, p.smem, st);
  return launch<R, 1>(vals, gid, mask, n, s, 0, buf, aux, p.grid, p.block,
                      p.cluster, p.smem, st);
}

// The opt-in above 48 KB of dynamic shared memory (static shared memory
// counts against the 48 KB too) for one instantiation, on the current
// device.
template <int R, int VEC>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(segsum_decimal_kernel<R, VEC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemDynMax);
}

}  // namespace

// Prepares the current device for the launcher: the shared-memory opt-in
// of every instantiation that uses shared memory.  Called once a device
// before the first launch; returns the first CUDA error, or 0.
extern "C" int segsum_decimal_prepare() {
  const cudaError_t errs[] = {allow_smem<kSmem, 1>(), allow_smem<kSmem, 4>(),
                              allow_smem<kCluster, 1>(),
                              allow_smem<kCluster, 4>()};
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return (int)e;
  return 0;
}

// Zeroes `buf` (int64 [2, num_segments]: sums, counts) on `stream` and,
// when plan->grid > 0, launches the kernel once with the caller's plan
// (ops/segsum.py::Plan): regime (0 global, 1 shared memory, 2 cluster of
// 2), grid, block, cluster and dynamic shared-memory bytes.  `aux`
// (int64 [2]) is the stream's flag and ticket words, zero on entry and
// left zero.  Returns the first CUDA error, or 0.
extern "C" int segsum_decimal_launch(const void* vals, const void* gid,
                                     const void* mask, long long n,
                                     int num_segments, void* buf, void* aux,
                                     const Plan* plan, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      buf, 0, 2 * (size_t)num_segments * sizeof(long long), st);
  if (err != cudaSuccess || plan->grid <= 0) return (int)err;
  const int s = num_segments;
  if (plan->regime == kGlobal)
    err = launch_vec<kGlobal>(vals, gid, mask, n, s, buf, aux, *plan, st);
  else if (plan->regime == kSmem)
    err = launch_vec<kSmem>(vals, gid, mask, n, s, buf, aux, *plan, st);
  else if (plan->regime == kCluster)
    err = launch_vec<kCluster>(vals, gid, mask, n, s, buf, aux, *plan, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
