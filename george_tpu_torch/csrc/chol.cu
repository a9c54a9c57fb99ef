// Batched lower Cholesky of SPD blocks for the hierarchical solver's leaf
// boxes (replaces george_tpu/ops/chol.py::pallas_cholesky_blocked).
//
// What it computes: for each of B row-major (m, m) SPD blocks A_b, the
// lower factor L_b with L_b L_b^T = A_b, the upper triangle written as
// exact zeros. Right-looking: per column k, the pivot
// inv = rsqrt(max(S_kk, 1e-30)) (the TPU kernel's floor, so a near-singular
// leaf stays finite), the scaled column L[k:, k] = S[k:, k] * inv, then
// the rank-1 update S[i, j] -= L[i, k] L[j, k] of the trailing lower
// triangle (k < j <= i < m).
//
// Design: one CTA per block, 256 threads. Column k is staged in a small
// shared vector (colk) so the update reads it contiguously; each warp
// takes whole rows of the trailing triangle and its lanes walk the
// columns of a row, so shared and global accesses are unit-stride. Two
// __syncthreads() per column. Scalar FP32/FP64 FMAs only, no tensor cores:
// the trailing update is where a reduced-precision contraction sends
// near-singular leaves indefinite.
//
// Two variants of the same kernel:
//   * SMEM: the whole block lives in dynamic shared memory when
//     (m*m + m) * sizeof(T) fits the opt-in limit (227 KB on sm_90), e.g.
//     f32 m=196 (150 KB);
//   * global: otherwise the factorization runs in place on the output in
//     device memory (f32 m=489, f64 m=196), with only colk in shared
//     memory.
//
// What bounds it: m dependent column steps per block, each a barrier plus
// a trailing update of (m-k)^2/2 FMAs spread over 256 threads; at m=196
// and B=512 that is 196 serial steps per CTA, and with one 150 KB CTA
// resident per SM the 512 blocks run in about four waves over 132 SMs.
// Panel blocking (several columns per barrier, the trailing update as a
// small GEMM) and more than one block per CTA are what a later version
// would add.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }
__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T, bool kSmem>
__global__ void __launch_bounds__(kThreads)
chol_kernel(const T* __restrict__ A, T* L, int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const size_t mm = static_cast<size_t>(m) * m;
  const T* Ab = A + blockIdx.x * mm;
  T* Lb = L + blockIdx.x * mm;
  T* S = kSmem ? smem : Lb;          // the working (Schur complement) copy
  T* colk = kSmem ? smem + mm : smem;

  for (size_t idx = threadIdx.x; idx < mm; idx += blockDim.x) {
    S[idx] = Ab[idx];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const T tiny = T(1e-30);

  for (int k = 0; k < m; ++k) {
    // pivot and scale column k. Every thread reads the diagonal, so its
    // scaled value goes to colk only and reaches S after the barrier.
    const size_t kk = static_cast<size_t>(k) * m + k;
    const T d = S[kk];
    const T inv = rsqrt_t(d > tiny ? d : tiny);
    for (int i = k + threadIdx.x; i < m; i += blockDim.x) {
      const size_t ik = static_cast<size_t>(i) * m + k;
      const T v = S[ik] * inv;
      if (i > k) S[ik] = v;
      colk[i] = v;
    }
    __syncthreads();
    if (threadIdx.x == 0) S[kk] = colk[k];
    // rank-1 update of the trailing lower triangle, one row per warp
    for (int i = k + 1 + warp; i < m; i += nwarps) {
      const T li = colk[i];
      T* row = S + static_cast<size_t>(i) * m;
      for (int j = k + 1 + lane; j <= i; j += 32) {
        row[j] = fma_t(-li, colk[j], row[j]);
      }
    }
    __syncthreads();
  }

  // lower triangle out, exact zeros above the diagonal
  for (size_t idx = threadIdx.x; idx < mm; idx += blockDim.x) {
    const int i = static_cast<int>(idx / m);
    const int j = static_cast<int>(idx % m);
    Lb[idx] = (j <= i) ? S[idx] : T(0);
  }
}

int smem_optin_bytes() {
  int dev = 0;
  int bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return 0;
  }
  return bytes;
}

bool fits_smem(int m, size_t elem) {
  const size_t need = (static_cast<size_t>(m) * m + m) * elem;
  return need <= static_cast<size_t>(smem_optin_bytes());
}

template <typename T>
int launch(const T* A, T* L, int B, int m, cudaStream_t stream) {
  if (B <= 0 || m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool smem = fits_smem(m, sizeof(T));
  const size_t bytes =
      (smem ? static_cast<size_t>(m) * m + m : static_cast<size_t>(m)) *
      sizeof(T);
  cudaError_t err;
  if (smem) {
    err = cudaFuncSetAttribute(chol_kernel<T, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    chol_kernel<T, true><<<B, kThreads, bytes, stream>>>(A, L, m);
  } else {
    err = cudaFuncSetAttribute(chol_kernel<T, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    chol_kernel<T, false><<<B, kThreads, bytes, stream>>>(A, L, m);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Factor B row-major (m, m) blocks of A into L (distinct buffers) on
// `stream`. Returns the cudaError_t of the launch (0 on success).
int george_chol_f32(const float* A, float* L, int B, int m, void* stream) {
  return launch<float>(A, L, B, m, static_cast<cudaStream_t>(stream));
}

int george_chol_f64(const double* A, double* L, int B, int m, void* stream) {
  return launch<double>(A, L, B, m, static_cast<cudaStream_t>(stream));
}

// 1 when blocks of order m with elements of elem_size bytes take the
// shared-memory variant on the current device, else 0.
int george_chol_uses_smem(int m, int elem_size) {
  return fits_smem(m, static_cast<size_t>(elem_size)) ? 1 : 0;
}

}  // extern "C"
