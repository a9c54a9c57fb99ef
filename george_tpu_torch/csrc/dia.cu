// Banded (DIA) matrix times a block of right-hand sides, for the sparse
// solver's fixed-theta applications (replaces
// george_tpu/ops/dia.py::dia_matvec_pallas).
//
// What it computes: for an n x n band stored as the row-major (n, D) value
// table vals, vals[i, j] = K[i, i + d_min + j] (zero where the slot falls
// outside the row's neighbors), and Y (n, r) row-major,
//   out[i, c] = diag[i] * Y[i, c] + sum_j vals[i, j] * Y[i + d_min + j, c],
// with Y read as zero outside rows [0, n). The offsets are always the
// contiguous range d_min .. d_min + D - 1 (sparse.banded_offsets returns
// nothing else), so the kernel takes (d_min, D) instead of an offsets array.
//
// What bounds it: memory. One pass reads the value table (n*D words), Y
// and diag once and writes out once: at n = 2e5, D ~ 301, f32 the table
// alone is 241 MB (more than the 50 MB L2), about r/2 flop per byte against
// a float32 ridge near 20 (67 TFLOP/s over 3.35 TB/s).
//
// Design:
//   * the table is read once for all r columns (up to 16 per pass; wider
//     blocks take further passes over the row, which hit L1/L2): the TPU
//     kernel re-read it per column under vmap. Two instantiations per
//     dtype and variant: one column (CG's solves), and 16 per pass (the
//     SLQ and gradient probe blocks; 17 columns run as 16 + 1), since 16
//     partial sums per lane keep the register count near 64 where 32 took
//     twice the registers and half the occupancy;
//   * each CTA owns kRows consecutive rows and stages their window of Y
//     (rows i0 + d_min .. i0 + kRows - 1 + d_min + D - 1, all r columns,
//     zero outside [0, n)) in shared memory once, column-major, so the
//     lanes of a warp read consecutive words (no bank conflicts);
//   * one warp per row: its lanes stride over the row's D contiguous table
//     entries (coalesced), each lane keeps one partial sum per column, a
//     warp-shuffle reduction follows, and diag[i] * Y[i, c] is added last;
//     lane c writes column c, so the row's outputs are one coalesced store;
//   * 64-bit indexing for i * D and i * r.
// Two variants of the same kernel, chosen at launch as chol.cu chooses its
// own: the window in dynamic shared memory when (kRows + D - 1) * r words
// fit the opt-in limit (227 KB on sm_90), else Y read through L2 from
// device memory (a very wide band times many columns).
// The shared-memory loads (r per table entry) bound the multi-column case
// before the table stream does; cp.async/TMA pipelining of the table and a
// persistent grid are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 128;     // rows per CTA, 16 per warp
constexpr int kMaxCols = 16;   // columns accumulated per pass over a row

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T, int RC, bool kSmem>
__global__ void __launch_bounds__(kThreads)
dia_kernel(const T* __restrict__ vals, const T* __restrict__ diag,
           const T* __restrict__ y, T* __restrict__ out, long long n, int D,
           int d_min, int r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);
  const long long i0 = static_cast<long long>(blockIdx.x) * kRows;
  const int W = kRows + D - 1;
  const long long g0 = i0 + d_min;   // row of Y at window row 0

  if (kSmem) {
    const int total = W * r;
    for (int t = threadIdx.x; t < total; t += kThreads) {
      const int w = t / r;
      const int c = t - w * r;
      const long long g = g0 + w;
      win[c * W + w] = (g >= 0 && g < n) ? y[g * r + c] : T(0);
    }
    __syncthreads();
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int row = warp; row < kRows; row += kWarps) {
    const long long i = i0 + row;
    if (i >= n) break;
    const T* vrow = vals + i * D;
    for (int c0 = 0; c0 < r; c0 += RC) {
      const int rc = (r - c0 < RC) ? r - c0 : RC;
      T acc[RC];
#pragma unroll
      for (int c = 0; c < RC; ++c) acc[c] = T(0);
#pragma unroll 4
      for (int j = lane; j < D; j += 32) {
        const T v = vrow[j];
        if (kSmem) {
          const T* wp = win + c0 * W + row + j;
#pragma unroll
          for (int c = 0; c < RC; ++c) {
            if (c < rc) acc[c] = fma_t(v, wp[c * W], acc[c]);
          }
        } else {
          const long long g = i + d_min + j;
          if (g >= 0 && g < n) {
            const T* yp = y + g * r + c0;
#pragma unroll
            for (int c = 0; c < RC; ++c) {
              if (c < rc) acc[c] = fma_t(v, yp[c], acc[c]);
            }
          }
        }
      }
      T mine = T(0);
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        if (c < rc) {
          T s = acc[c];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            s += __shfl_xor_sync(0xffffffffu, s, o);
          }
          if (lane == c) mine = s;
        }
      }
      if (lane < rc) {
        const long long idx = i * r + c0 + lane;
        out[idx] = fma_t(diag[i], y[idx], mine);
      }
    }
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

size_t window_bytes(int D, int r, size_t elem) {
  return (static_cast<size_t>(kRows) + D - 1) * static_cast<size_t>(r) * elem;
}

bool fits_smem(int D, int r, size_t elem) {
  return window_bytes(D, r, elem) <= static_cast<size_t>(smem_optin_bytes());
}

template <typename T, int RC>
int go(bool smem, size_t bytes, unsigned grid, cudaStream_t stream,
       const T* vals, const T* diag, const T* y, T* out, long long n, int D,
       int d_min, int r) {
  if (smem) {
    if (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          dia_kernel<T, RC, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    dia_kernel<T, RC, true><<<grid, kThreads, bytes, stream>>>(
        vals, diag, y, out, n, D, d_min, r);
  } else {
    dia_kernel<T, RC, false><<<grid, kThreads, 0, stream>>>(
        vals, diag, y, out, n, D, d_min, r);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* vals, const T* diag, const T* y, T* out, long long n,
           int D, int d_min, int r, cudaStream_t stream) {
  if (n < 0 || D <= 0 || r < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || r == 0) return 0;
  const bool smem = fits_smem(D, r, sizeof(T));
  const size_t bytes = smem ? window_bytes(D, r, sizeof(T)) : 0;
  const unsigned grid = static_cast<unsigned>((n + kRows - 1) / kRows);
  if (r == 1) {
    return go<T, 1>(smem, bytes, grid, stream, vals, diag, y, out, n, D,
                    d_min, r);
  }
  return go<T, kMaxCols>(smem, bytes, grid, stream, vals, diag, y, out, n, D,
                         d_min, r);
}

}  // namespace

extern "C" {

// out = (band(vals) + diag) * y for row-major vals (n, D), diag (n,),
// y and out (n, r) (distinct buffers), band offsets d_min .. d_min + D - 1,
// on `stream`. Returns the cudaError_t of the launch (0 on success).
int george_dia_f32(const float* vals, const float* diag, const float* y,
                   float* out, long long n, int D, int d_min, int r,
                   void* stream) {
  return launch<float>(vals, diag, y, out, n, D, d_min, r,
                       static_cast<cudaStream_t>(stream));
}

int george_dia_f64(const double* vals, const double* diag, const double* y,
                   double* out, long long n, int D, int d_min, int r,
                   void* stream) {
  return launch<double>(vals, diag, y, out, n, D, d_min, r,
                        static_cast<cudaStream_t>(stream));
}

// 1 when a band of D diagonals times r columns of elem_size bytes takes the
// shared-memory variant on the current device, else 0.
int george_dia_uses_smem(int D, int r, int elem_size) {
  return fits_smem(D, r, static_cast<size_t>(elem_size)) ? 1 : 0;
}

}  // extern "C"
