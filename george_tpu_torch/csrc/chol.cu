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
//
// Second entry point, george_chol_tile_*: the same function by the same
// unblocked right-looking recurrence, laid out as the counterpart of
// george_tpu/ops/chol.py::pallas_cholesky (several blocks per grid step,
// `block_tile`): one warp per block and several blocks per CTA. Each
// column step is warp-synchronous (__syncwarp, no CTA barriers): the lanes
// scale column k into a per-warp vector, then walk the trailing lower
// triangle row by row, consecutive lanes on consecutive columns. Each block
// sits in shared memory when it fits ((m*m + m) words; f32 m <= 128 is
// 64.5 KB, so 3 blocks per CTA) and in place in device memory otherwise.
// What bounds it: each block is a chain of m dependent steps run by one
// warp; the bytes (read A, write L: 2*B*m*m words) set the card's floor.

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

constexpr int kTileMaxWarps = 8;

template <typename T, bool kSmem>
__global__ void __launch_bounds__(kTileMaxWarps * 32)
chol_tile_kernel(const T* __restrict__ A, T* L, int B, int m, int per_cta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * per_cta + warp;
  if (b >= B) return;                 // the whole warp leaves together
  const size_t mm = static_cast<size_t>(m) * m;
  T* base = reinterpret_cast<T*>(smem_raw);
  const T* Ab = A + b * mm;
  T* Lb = L + b * mm;
  T* S = kSmem ? base + warp * (mm + m) : Lb;   // the Schur complement
  T* colk = kSmem ? S + mm : base + static_cast<size_t>(warp) * m;
  const T tiny = T(1e-30);

  for (size_t idx = lane; idx < mm; idx += 32) S[idx] = Ab[idx];
  __syncwarp();
  for (int k = 0; k < m; ++k) {
    const T d = S[static_cast<size_t>(k) * m + k];
    const T inv = rsqrt_t(d > tiny ? d : tiny);
    __syncwarp();                     // every lane has read d before lane 0
                                      // overwrites it below
    for (int i = k + lane; i < m; i += 32) {
      const size_t ik = static_cast<size_t>(i) * m + k;
      const T v = S[ik] * inv;
      colk[i] = v;
      S[ik] = v;
    }
    __syncwarp();
    for (int i = k + 1; i < m; ++i) {
      const T li = colk[i];
      T* row = S + static_cast<size_t>(i) * m;
      for (int j = k + 1 + lane; j <= i; j += 32) {
        row[j] = fma_t(-li, colk[j], row[j]);
      }
    }
    __syncwarp();
  }
  for (size_t idx = lane; idx < mm; idx += 32) {
    const int i = static_cast<int>(idx / m);
    const int j = static_cast<int>(idx % m);
    Lb[idx] = (j <= i) ? S[idx] : T(0);
  }
}

// blocks of order m per CTA in the tiled kernel's shared-memory variant
// (at most kTileMaxWarps), or 0 when one block does not fit
int tile_blocks_per_cta(int m, size_t elem) {
  const size_t per = (static_cast<size_t>(m) * m + m) * elem;
  const size_t fit = static_cast<size_t>(smem_optin_bytes()) / per;
  return static_cast<int>(fit < kTileMaxWarps ? fit : kTileMaxWarps);
}

template <typename T>
int launch_tile(const T* A, T* L, int B, int m, cudaStream_t stream) {
  if (B <= 0 || m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int fit = tile_blocks_per_cta(m, sizeof(T));
  const bool smem = fit > 0;
  int per_cta = smem ? fit : kTileMaxWarps;
  if (per_cta > B) per_cta = B;
  const size_t bytes =
      static_cast<size_t>(per_cta) *
      (smem ? static_cast<size_t>(m) * m + m : static_cast<size_t>(m)) *
      sizeof(T);
  const unsigned grid = static_cast<unsigned>((B + per_cta - 1) / per_cta);
  cudaError_t err;
  if (smem) {
    err = cudaFuncSetAttribute(chol_tile_kernel<T, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    chol_tile_kernel<T, true><<<grid, 32 * per_cta, bytes, stream>>>(
        A, L, B, m, per_cta);
  } else {
    err = cudaFuncSetAttribute(chol_tile_kernel<T, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    chol_tile_kernel<T, false><<<grid, 32 * per_cta, bytes, stream>>>(
        A, L, B, m, per_cta);
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

// The tiled entry point (one warp per block, several blocks per CTA): same
// contract as george_chol_f32/_f64.
int george_chol_tile_f32(const float* A, float* L, int B, int m,
                         void* stream) {
  return launch_tile<float>(A, L, B, m, static_cast<cudaStream_t>(stream));
}

int george_chol_tile_f64(const double* A, double* L, int B, int m,
                         void* stream) {
  return launch_tile<double>(A, L, B, m, static_cast<cudaStream_t>(stream));
}

// Blocks per CTA of the tiled kernel's shared-memory variant for order m
// and elem_size-byte elements on the current device; 0 means the
// device-memory variant.
int george_chol_tile_blocks_per_cta(int m, int elem_size) {
  return tile_blocks_per_cta(m, static_cast<size_t>(elem_size));
}

}  // extern "C"
