// The 2D-only path's mirror pose and model normal on Hopper, bit for bit
// with their plain versions.
//
// M1 tod_mirror_poses replaces, on the card, the reference's mirror branch
// (tod_tpu/geometry/detection2d.py:172-186, jax.vmap of `mirror` over the
// top poses): not a Pallas kernel, but XLA's fusions of the dots, the cross
// product, the libm atan2f / sinf / cosf calls and the two 3x3 products.
// The plain version is tod_tpu_torch/geometry/detection2d.py
// mirror_poses_torch: a chain of small tensor ops contracted as the
// compiled reference's fusions are (R n, ax ax and Q R fused multiply-add
// chains, the reflection's x and y and each cross-product entry an FMA),
// glibc's atan2f and sincosf. On the 2D path its device code (mirror.cuh)
// runs inside kernel R1's selection (csrc/consensus.cu), as does M2's.
//
// M2 tod_sym3_smallest replaces the reference's jnp.linalg.eigh of the
// model points' covariance (detection2d.py:164-169, the eigenvector of the
// smallest eigenvalue): LAPACK's ssyevd at n = 3 as the reference host runs
// it (geometry/lapack.py syevd3, its plain version through detection2d.py
// sym3_smallest_vector_torch), the same bits and the same sign.
//
// Both were chains of 40-70 elementwise launches a call (two of them L1e's
// atan2f, two L4's sincosf / cosf) on a few hundred elements: launch-bound.
// Design: one thread a pose (M1) or matrix (M2), one launch a call. Every
// float32 operation is an __f*_rn in the plain version's order (nvcc never
// contracts them into an FMA; the contracted ones and M2's multiply-adds,
// OpenBLAS's, are __fmaf_rn), the square roots __fsqrt_rn (the plain
// versions' ops/libm.py sqrt_rn and numpy's), the divisions __fdiv_rn, and atan2f
// and sincosf glibc's (libm_f32.cuh, as L1e and L4 compute them), so the
// card gives the CPU's bits. M1's clamps keep a NaN, as torch.clamp does.
// M2 runs LAPACK's data-dependent QL/QR iteration with its branches; its
// few small arrays, indexed at run time, sit in local memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mirror.cuh"

namespace {

using namespace tod_mirror;

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
mirror_kernel(const float* __restrict__ R, const float* __restrict__ T,
              const float* __restrict__ n, float* __restrict__ R_out,
              float* __restrict__ T_out, int n_poses, int per_object) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_poses) return;
  mirror_one(R + 9 * static_cast<int64_t>(i), T + 3 * static_cast<int64_t>(i),
             n + 3 * static_cast<int64_t>(i / per_object),
             R_out + 9 * static_cast<int64_t>(i),
             T_out + 3 * static_cast<int64_t>(i));
}

__global__ void __launch_bounds__(kThreads)
sym3_kernel(const float* __restrict__ cov, float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) sym3_one(cov + 9 * static_cast<int64_t>(i),
                      out + 3 * static_cast<int64_t>(i));
}

}  // namespace

// R_out = Q R and T_out = T for n_poses contiguous float32 poses (R: 9
// floats a pose, T: 3), the normal n (3 floats) shared by each run of
// per_object consecutive poses. Launches on `stream` and returns
// cudaGetLastError(); it neither allocates nor synchronises.
extern "C" int tod_mirror_poses(const void* R, const void* T, const void* n,
                                void* R_out, void* T_out, int n_poses,
                                int per_object, void* stream) {
  if (n_poses <= 0) return 0;
  if (per_object < 1 || n_poses % per_object)
    return static_cast<int>(cudaErrorInvalidValue);
  mirror_kernel<<<(n_poses + kThreads - 1) / kThreads, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(R), static_cast<const float*>(T),
      static_cast<const float*>(n), static_cast<float*>(R_out),
      static_cast<float*>(T_out), n_poses, per_object);
  return static_cast<int>(cudaGetLastError());
}

// out (3 floats a matrix) = the unit eigenvector of the smallest eigenvalue
// of each of n contiguous symmetric float32 3x3 matrices. Launches on
// `stream` and returns cudaGetLastError(); it neither allocates nor
// synchronises.
extern "C" int tod_sym3_smallest(const void* cov, void* out, int n,
                                 void* stream) {
  if (n <= 0) return 0;
  sym3_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cov), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
