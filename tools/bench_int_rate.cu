// Throughput of the two CUDA-core operations the matcher kernels are
// bound by: __popc (csrc/segmented_top1.cu, 8 a descriptor pair) and __dp4a
// (csrc/segmented_l2_top1.cu, 32 a pair). Every thread runs kChains
// independent dependency chains of one operation, so with all SMs full
// the time is set by the operation's pipe, not by latency. Built and run
// by tools/bench_int_rate.py.

#include <cuda_runtime.h>

namespace {

constexpr int kChains = 8;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

template <bool kDp4a>
__global__ void __launch_bounds__(kThreads)
chains(const int* __restrict__ seed, int* __restrict__ out, int iters) {
  int a[kChains], x[kChains];
#pragma unroll
  for (int i = 0; i < kChains; ++i) {
    x[i] = seed[(threadIdx.x + i) & 255];
    a[i] = seed[(threadIdx.x + 31 * i) & 255];
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < kChains; ++i) {
      if (kDp4a) {
        a[i] = __dp4a(x[i], x[(i + 1) % kChains], a[i]);
      } else {
        // one popc and two ALU operations (another pipe)
        a[i] = __popc(a[i] ^ x[i]) + x[(i + 1) % kChains];
      }
    }
  }
  int sum = 0;
#pragma unroll
  for (int i = 0; i < kChains; ++i) sum += a[i];
  out[blockIdx.x * kThreads + threadIdx.x] = sum;
}

}  // namespace

// Runs one kernel of `iters` rounds and reports its time and the number of
// operations of the measured kind it ran (per thread, not per warp).
// `op`: 0 = __popc, 1 = __dp4a. Returns a cudaError_t.
extern "C" int bench_int_rate(int op, int iters, float* ms,
                                double* operations, int* n_sm,
                                int* clock_khz) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, device);
  cudaDeviceGetAttribute(clock_khz, cudaDevAttrClockRate, device);
  const int blocks = *n_sm * kBlocksPerSm;
  unsigned host_seed[256];
  for (int i = 0; i < 256; ++i) host_seed[i] = 0x01020304u * (i + 1) + i;
  int *seed = nullptr, *out = nullptr;
  if ((err = cudaMalloc(&seed, sizeof(host_seed))) != cudaSuccess ||
      (err = cudaMalloc(&out, sizeof(int) * blocks * kThreads)) !=
          cudaSuccess) {
    return static_cast<int>(err);
  }
  cudaMemcpy(seed, host_seed, sizeof(host_seed), cudaMemcpyHostToDevice);
  cudaEvent_t start, stop;
  cudaEventCreate(&start);
  cudaEventCreate(&stop);
  for (int run = 0; run < 2; ++run) {   // the first run warms up
    cudaEventRecord(start);
    if (op == 1) {
      chains<true><<<blocks, kThreads>>>(seed, out, iters);
    } else {
      chains<false><<<blocks, kThreads>>>(seed, out, iters);
    }
    cudaEventRecord(stop);
    cudaEventSynchronize(stop);
  }
  cudaEventElapsedTime(ms, start, stop);
  *operations = static_cast<double>(blocks) * kThreads * kChains * iters;
  err = cudaGetLastError();
  cudaEventDestroy(start);
  cudaEventDestroy(stop);
  cudaFree(seed);
  cudaFree(out);
  return static_cast<int>(err);
}
