// Throughput of the operations the matcher kernels are bound by: on the
// CUDA cores __popc (csrc/segmented_top1.cu, 8 a descriptor pair) and
// __dp4a (32 an int8 L2 pair); on the tensor cores mma.sync m16n8k32 s8
// (csrc/segmented_l2_top1.cu B3, and T1's s8 route) and mma.sync
// m16n8k256 b1 .and.popc (csrc/hamming_topk.cu), whose rate on Hopper no
// data sheet gives; and the warpgroup products wgmma m64n256k32 s8 and
// m64n256k256 b1 .and.popc (A from shared memory or from registers), the
// way to the tensor cores' full rate. Every thread (every warp, for mma)
// runs kChains independent dependency chains of one operation, and every
// warpgroup keeps wgmma groups in flight, so with all SMs full the time is
// set by the operation's pipe, not by latency. Built and run by
// tools/bench_int_rate.py.

#include <cuda_runtime.h>

namespace {

constexpr int kChains = 8;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

// kChains independent accumulators a warp, each one m16n8k32 s8 (kB1
// false) or m16n8k256 b1 (kB1 true) mma a round on fixed fragments.
template <bool kB1>
__global__ void __launch_bounds__(kThreads)
mma_chains(const int* __restrict__ seed, int* __restrict__ out, int iters) {
  const int t = threadIdx.x;
  const unsigned a0 = seed[t & 255], a1 = seed[(t + 1) & 255];
  const unsigned a2 = seed[(t + 2) & 255], a3 = seed[(t + 3) & 255];
  const unsigned b0 = seed[(t + 4) & 255], b1 = seed[(t + 5) & 255];
  int c[kChains][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < kChains; ++i) {
      if (kB1) {
        asm volatile(
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(c[i][0]), "+r"(c[i][1]), "+r"(c[i][2]), "+r"(c[i][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(c[i][0]), "+r"(c[i][1]), "+r"(c[i][2]), "+r"(c[i][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
    }
  }
  int sum = 0;
#pragma unroll
  for (int i = 0; i < kChains; ++i)
    sum += c[i][0] + c[i][1] + c[i][2] + c[i][3];
  out[blockIdx.x * kThreads + threadIdx.x] = sum;
}

// wgmma: one warpgroup a block, kWgInFlight products a commit group and
// one group kept in flight, on fixed operands: A (64 rows x 32 bytes) and
// B (256 rows x 32 bytes) K-major in shared memory without swizzle (8-row
// x 16-byte core matrices, the K neighbour 128 bytes on, the next 8 rows
// 256 bytes on), or A as the registers of the m64nNk256 b1 fragment.
constexpr int kWgThreads = 128;
constexpr int kWgBlocksPerSm = 2;
constexpr int kWgInFlight = 4;
enum WgOp : int { kWgB1 = 0, kWgS8 = 1, kWgB1RegA = 2 };

__device__ __forceinline__ unsigned long long smem_desc(const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  return static_cast<unsigned long long>((a >> 4) & 0x3FFF)
         | (static_cast<unsigned long long>(128 >> 4) << 16)
         | (static_cast<unsigned long long>(256 >> 4) << 32);
}

#define WG_D                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
  "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
  "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, " \
  "%71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, " \
  "%85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, " \
  "%99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, " \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "     \
  "%122, %123, %124, %125, %126, %127}"
#define D4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define D16(i) D4(i), D4(i + 4), D4(i + 8), D4(i + 12)
#define D64(i) D16(i), D16(i + 16), D16(i + 32), D16(i + 48)

template <int kOp>
__device__ __forceinline__ void wgmma(int (&d)[128], unsigned long long da,
                                      unsigned long long db,
                                      const unsigned (&a)[4]) {
  if (kOp == kWgB1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k256.s32.b1.b1.and.popc "
        WG_D ", %128, %129, p;\n}\n"
        : D64(0), D64(64) : "l"(da), "l"(db), "r"(1));
  } else if (kOp == kWgS8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
        WG_D ", %128, %129, p;\n}\n"
        : D64(0), D64(64) : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k256.s32.b1.b1.and.popc "
        WG_D ", {%128, %129, %130, %131}, %132, p;\n}\n"
        : D64(0), D64(64)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

// Keeps the compiler from moving accumulator reads or writes across the
// wgmma fence and waits.
__device__ __forceinline__ void fence_acc(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int kOp>
__global__ void __launch_bounds__(kWgThreads)
wgmma_chains(const int* __restrict__ seed, int* __restrict__ out,
             int iters) {
  __shared__ __align__(128) unsigned smem[(64 + 256) * 32 / 4];
  for (int i = threadIdx.x; i < (64 + 256) * 8; i += kWgThreads)
    smem[i] = seed[i & 255];
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const unsigned long long da = smem_desc(smem);
  const unsigned long long db = smem_desc(smem + 64 * 8);
  const unsigned a[4] = {smem[threadIdx.x], smem[threadIdx.x + 128],
                         smem[threadIdx.x + 256], smem[threadIdx.x + 384]};
  int d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0;
  fence_acc(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kWgInFlight; ++j) wgmma<kOp>(d, da, db, a);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(d);
  int sum = 0;
#pragma unroll
  for (int i = 0; i < 128; ++i) sum += d[i];
  out[blockIdx.x * kWgThreads + threadIdx.x] = sum;
}

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
// operations of the measured kind it ran: per thread for `op` 0 = __popc
// and 1 = __dp4a; for 2 = mma s8 m16n8k32 the int8 operations (2 x 16 x 8
// x 32 an mma, a multiply and an add each) and for 3 = mma b1 m16n8k256
// the bit operations (2 x 16 x 8 x 256 an mma, an AND and a popcount add
// each); for 4 = wgmma b1 m64n256k256, 5 = wgmma s8 m64n256k32 and 6 =
// wgmma b1 with A in registers the same, 2 x 64 x 256 x K a product.
// Returns a cudaError_t.
extern "C" int bench_int_rate(int op, int iters, float* ms,
                                double* operations, int* n_sm,
                                int* clock_khz) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, device);
  cudaDeviceGetAttribute(clock_khz, cudaDevAttrClockRate, device);
  const bool wg = op >= 4;
  const int blocks = *n_sm * (wg ? kWgBlocksPerSm : kBlocksPerSm);
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
    if (op == 6) {
      wgmma_chains<kWgB1RegA><<<blocks, kWgThreads>>>(seed, out, iters);
    } else if (op == 5) {
      wgmma_chains<kWgS8><<<blocks, kWgThreads>>>(seed, out, iters);
    } else if (op == 4) {
      wgmma_chains<kWgB1><<<blocks, kWgThreads>>>(seed, out, iters);
    } else if (op == 3) {
      mma_chains<true><<<blocks, kThreads>>>(seed, out, iters);
    } else if (op == 2) {
      mma_chains<false><<<blocks, kThreads>>>(seed, out, iters);
    } else if (op == 1) {
      chains<true><<<blocks, kThreads>>>(seed, out, iters);
    } else {
      chains<false><<<blocks, kThreads>>>(seed, out, iters);
    }
    cudaEventRecord(stop);
    cudaEventSynchronize(stop);
  }
  cudaEventElapsedTime(ms, start, stop);
  *operations = static_cast<double>(blocks) * kThreads * kChains * iters;
  if (op >= 2 && !wg)   // one mma a warp, not a thread
    *operations = *operations / 32.0 * 2.0 * 16 * 8 * (op == 3 ? 256 : 32);
  if (wg)               // kWgInFlight wgmma a warpgroup (block) a round
    *operations = static_cast<double>(blocks) * iters * kWgInFlight * 2.0
                  * 64 * 256 * (op == 5 ? 32 : 256);
  err = cudaGetLastError();
  cudaEventDestroy(start);
  cudaEventDestroy(stop);
  cudaFree(seed);
  cudaFree(out);
  return static_cast<int>(err);
}
