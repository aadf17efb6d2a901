// Masked per-segment float32 sums.
//
// Replaces the TPU kernel ndstpu/ops/segsum.py::_f32_kernel (reached
// through segment_sum_f32).  On the TPU the sums ran on the MXU as one-hot
// matrix products, tiled rows x segments, because the systolic array is the
// TPU's fast path for a reduction over a small key domain.  Hopper has no
// such constraint: this kernel is a scatter, one thread per row in a
// grid-stride loop, with atomicAdd on float32.
//
// When the segments fit in shared memory (up to kSmemSegs), each block
// first adds its rows into a private histogram in shared memory and then
// adds the non-zero bins into the output with one global atomic each, so
// hot segments contend inside one SM and not across the card.  Above that,
// the rows add straight into the output with global atomics.
//
// Contract (the TPU function's): rows with mask == 0 and rows whose gid is
// outside [0, s) add nothing; the result is float32 [s].  Float atomics add
// in no fixed order, so the sums agree with any other order only within a
// tolerance, not bit for bit.
//
// Bound: memory.  The kernel reads 9 bytes a row (float32 value, int32
// gid, bool mask) and writes 4 bytes a segment, at 3.35 TB/s on an H100
// SXM.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC  (ndstpu_torch/ops/build.py)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// 48 KB of dynamic shared memory needs no opt-in attribute
constexpr int kSmemSegs = 12288;

__global__ void segsum_f32_global(const float* __restrict__ vals,
                                  const int* __restrict__ gid,
                                  const bool* __restrict__ mask, long long n,
                                  int num_segments, float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (!mask[i]) continue;
    const int g = gid[i];
    if (g < 0 || g >= num_segments) continue;
    atomicAdd(&out[g], vals[i]);
  }
}

__global__ void segsum_f32_shared(const float* __restrict__ vals,
                                  const int* __restrict__ gid,
                                  const bool* __restrict__ mask, long long n,
                                  int num_segments, float* __restrict__ out) {
  extern __shared__ float hist[];
  for (int s = threadIdx.x; s < num_segments; s += blockDim.x) hist[s] = 0.f;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (!mask[i]) continue;
    const int g = gid[i];
    if (g < 0 || g >= num_segments) continue;
    atomicAdd(&hist[g], vals[i]);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < num_segments; s += blockDim.x) {
    const float h = hist[s];
    if (h != 0.f) atomicAdd(&out[s], h);
  }
}

}  // namespace

// Launches on `stream`.  `out` must be zeroed by the caller.  Returns
// cudaGetLastError() after the launch.
extern "C" int segsum_f32_launch(const void* vals, const void* gid,
                                 const void* mask, long long n,
                                 int num_segments, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    int sms = 0, dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long want = (n + kThreads - 1) / kThreads;
    const float* v = static_cast<const float*>(vals);
    const int* g = static_cast<const int*>(gid);
    const bool* m = static_cast<const bool*>(mask);
    float* o = static_cast<float*>(out);
    if (num_segments <= kSmemSegs) {
      // few blocks, each flushes its whole histogram once
      const long long cap = (long long)sms * 4;
      const int blocks = (int)(want < cap ? want : cap);
      segsum_f32_shared<<<blocks, kThreads, num_segments * sizeof(float),
                          st>>>(v, g, m, n, num_segments, o);
    } else {
      const long long cap = (long long)sms * 8;
      const int blocks = (int)(want < cap ? want : cap);
      segsum_f32_global<<<blocks, kThreads, 0, st>>>(v, g, m, n,
                                                     num_segments, o);
    }
  }
  return (int)cudaGetLastError();
}
