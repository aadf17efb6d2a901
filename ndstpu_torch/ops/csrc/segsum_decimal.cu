// Exact masked per-segment int64 sums and row counts for scaled decimals.
//
// Replaces the TPU kernel ndstpu/ops/segsum.py::_limb_kernel (reached
// through segment_sum_decimal).  On the TPU the sums ran on the MXU as
// one-hot matrix products over 8-bit limb planes, because the TPU has no
// native 64-bit integer adder.  Hopper adds 64-bit integers natively, so
// this kernel is a plain scatter: one thread per row in a grid-stride
// loop, atomicAdd on unsigned long long for the sums (two's-complement
// wrap gives the signed sum modulo 2^64, the same as the limb combine)
// and for the counts, and an atomicOr into a device flag when a masked-in
// value falls outside |v| < 2^41.  A second launch poisons every sum with
// -2^62 when the flag is set, the contract of the TPU function.
//
// Contract, kept bit-exact against the TPU function:
//   * rows with mask == 0, and rows whose gid is outside [0, s), add nothing;
//   * a row's count follows the TPU count plane (v + 2^41) != 0;
//   * if any masked-in |v| >= 2^41 (gid in range or not), every sum is -2^62.
// The one deliberate difference: the TPU function refuses more than
// (2^31 - 1) / 255 rows, because its limb accumulators are int32.  Here
// everything accumulates in 64 bits and that row limit is lifted.
//
// Bound: memory.  The kernel reads 13 bytes a row (int64 value, int32 gid,
// bool mask) and writes 16 bytes a segment, at 3.35 TB/s on an H100 SXM.
// Its known weakness is the global atomics: a Zipf-hot group serialises
// its rows on one address.  Privatising the histogram in shared memory is
// later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC  (ndstpu_torch/ops/build.py)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long kBias = 1LL << 41;
constexpr long long kPoison = -(1LL << 62);

__global__ void segsum_decimal_rows(const long long* __restrict__ vals,
                                    const int* __restrict__ gid,
                                    const bool* __restrict__ mask,
                                    long long n, int num_segments,
                                    unsigned long long* __restrict__ sums,
                                    unsigned long long* __restrict__ counts,
                                    int* __restrict__ oob_flag) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (!mask[i]) continue;
    const long long v = vals[i];
    if (v <= -kBias || v >= kBias) atomicOr(oob_flag, 1);
    const int g = gid[i];
    if (g < 0 || g >= num_segments) continue;
    atomicAdd(&sums[g], (unsigned long long)v);
    if (v != -kBias) atomicAdd(&counts[g], 1ULL);
  }
}

__global__ void segsum_decimal_poison(long long* __restrict__ sums,
                                      int num_segments,
                                      const int* __restrict__ oob_flag) {
  if (*oob_flag == 0) return;
  const int stride = gridDim.x * blockDim.x;
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < num_segments;
       s += stride)
    sums[s] = kPoison;
}

}  // namespace

// Launches both kernels on `stream`.  `sums`, `counts` and `oob_flag` must
// be zeroed by the caller.  Returns cudaGetLastError() after the launches.
extern "C" int segsum_decimal_launch(const void* vals, const void* gid,
                                     const void* mask, long long n,
                                     int num_segments, void* sums,
                                     void* counts, void* oob_flag,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  if (n > 0) {
    int sms = 0, dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    long long want = (n + threads - 1) / threads;
    long long cap = (long long)sms * 8;
    int blocks = (int)(want < cap ? want : cap);
    segsum_decimal_rows<<<blocks, threads, 0, st>>>(
        static_cast<const long long*>(vals), static_cast<const int*>(gid),
        static_cast<const bool*>(mask), n, num_segments,
        static_cast<unsigned long long*>(sums),
        static_cast<unsigned long long*>(counts),
        static_cast<int*>(oob_flag));
    if (num_segments > 0) {
      int pblocks = (num_segments + threads - 1) / threads;
      if (pblocks > 1024) pblocks = 1024;
      segsum_decimal_poison<<<pblocks, threads, 0, st>>>(
          static_cast<long long*>(sums), num_segments,
          static_cast<const int*>(oob_flag));
    }
  }
  return (int)cudaGetLastError();
}
