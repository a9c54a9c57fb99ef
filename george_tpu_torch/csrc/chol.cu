// Batched lower Cholesky of SPD blocks: both Cholesky kernels of the port.
//
// Replaces george_tpu/ops/chol.py::pallas_cholesky_blocked (entry points
// george_chol_f32/_f64, the HODLR leaf boxes) and
// george_tpu/ops/chol.py::pallas_cholesky (george_chol_tile_f32/_f64, the
// unblocked kernel that factors `block_tile` blocks per grid step). Both
// run the same device routine; only the launch plan differs, and the plan
// is computed in Python (ops/chol.py::launch_plan) and passed in.
//
// What it computes: for each of B row-major (m, m) SPD blocks A_b, the
// lower factor L_b with L_b L_b^T = A_b into a distinct buffer, the upper
// triangle as exact zeros. Per column k the pivot inv_k =
// rsqrt(max(S_kk, 1e-30)) (the TPU kernel's floor, so a near-singular leaf
// stays finite) and L[i, k] = S[i, k] * inv_k for i >= k. Any m, no
// identity padding in memory. Scalar FP32 / FP64 FMAs only: the trailing
// update is where a reduced-precision contraction sends near-singular
// leaves indefinite (the JAX kernel's HIGHEST-precision note).
//
// What bounds it on the card: not bytes (read the lower triangle of A,
// write L: 118 MB at (512, 196) f32, 35 us) nor FMAs (m^3/6 per block,
// 19 us) but the dependent chain of m column steps per block: taken column
// by column, each step is a barrier and a rank-1 update of one FMA per
// three shared-memory accesses.
//
// Design (right-looking, panels of NB = 32 columns, one group of warps per
// block). Per panel:
//   A. one warp factors the 32 x 32 diagonal block L11 in registers, lane i
//      holding row i; each scaled column goes to shared memory (D) and
//      comes back to every lane as 16-byte broadcasts. A ragged last panel
//      is padded with identity rows in registers only;
//   B. the rows below are solved against it (L21 = A21 L11^-T), one row per
//      thread, in registers, and land transposed in Pt;
//   C. the trailing lower triangle takes the panel's rank-32 update once,
//      S22 -= P P^T, as a register-tiled SYRK: each thread owns 4 x 4
//      outputs and reads two 4-wide vectors of Pt per 16 FMAs.
//   Look-ahead: the whole group applies C to the next panel's diagonal
//   block first, one entry a thread; then warp 0 factors that block (A of
//   the next panel) while the other warps run the rest of C. Three group
//   barriers per panel (four in device memory), about 3m/32 per block.
// Storage: the Schur complement S keeps only its lower triangle, packed,
// in shared memory when it fits (f32 m = 196: 77 KB, so two blocks per SM;
// f64 m = 196: 154 KB), else in place in the output in device memory
// (f32 m = 489), where C reads and writes each trailing element once per
// panel instead of once per column and the panel's rows are staged through
// Pt so that device memory is read and written row-contiguously. Pt is
// (32, m) in shared memory; past m ~ 1780 (f32) it goes to a scratch
// buffer in device memory that the caller allocates.
// Groups: a block is owned by `group_threads` threads (1 to 16 warps) with
// their own named barrier, and a CTA holds `blocks_per_cta` groups, so
// few large blocks get many warps each and many small blocks share CTAs
// (the tiled entry point's plan).

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kNB = 32;            // panel width: one warp's lanes
constexpr int kMaxThreads = 512;   // threads per CTA (launch bound)
constexpr int kMaxGroups = 16;     // named barriers 0..15, one per group

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }
__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// four consecutive elements from 16-byte aligned memory
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 q0 = *reinterpret_cast<const double2*>(p);
  const double2 q1 = *reinterpret_cast<const double2*>(p + 2);
  v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
}

// a named barrier of `nthreads` threads (a group's own)
__device__ __forceinline__ void bar_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(nthreads) : "memory");
}

__host__ __device__ __forceinline__ size_t round16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// Pt row stride: m rounded up to 4, so every 4-wide read is aligned
__host__ __device__ __forceinline__ int panel_stride(int m) {
  return (m + 3) / 4 * 4;
}

// Where the Schur complement and the panel live (the plan's variant).
enum Variant : int {
  kDevice = 0,        // S in place in the output, panel in shared memory
  kShared = 1,        // S packed and the panel, both in shared memory
  kDevicePanel = 2,   // S in the output, panel in the caller's scratch
};

// Elements of one block's panel workspace: Pt (kNB x panel_stride(m)), the
// diagonal block D (kNB x kNB) and its pivots (kNB, padded to 16 bytes).
__host__ __device__ __forceinline__ size_t panel_elems(int m) {
  return static_cast<size_t>(kNB) * (panel_stride(m) + kNB + 1) + kNB;
}

// Shared bytes of one group: [S packed lower triangle, shared variant only,
// rounded to 16 bytes][panel workspace, device-panel variant: none].
// ops/chol.py::_group_bytes computes the same sizes.
__host__ __device__ __forceinline__ size_t group_bytes(int m, size_t elem,
                                                      int variant) {
  if (variant == kDevicePanel) return 0;
  const size_t tri =
      variant == kShared
          ? round16(static_cast<size_t>(m) * (m + 1) / 2 * elem)
          : 0;
  return tri + panel_elems(m) * elem;
}

// Where S[i][j] (j <= i) lives: packed rows in shared memory, or the
// row-major output block in device memory.
template <bool kSmem>
__device__ __forceinline__ size_t at(int i, int j, int m) {
  return kSmem ? static_cast<size_t>(i) * (i + 1) / 2 + j
               : static_cast<size_t>(i) * m + j;
}

// row of the q-th entry of a lower triangle numbered row by row
__device__ __forceinline__ int tri_row(int q) {
  int i = static_cast<int>((sqrtf(8.0f * q + 1.0f) - 1.0f) * 0.5f);
  while (i * (i + 1) / 2 > q) --i;
  while ((i + 1) * (i + 2) / 2 <= q) ++i;
  return i;
}

// A: factor the w x w diagonal block at k0 (w <= 32) in one warp's
// registers, lane i holding row k0 + i. Column k of L11 goes to D
// (D[k * kNB + j] = L[k0 + j, k0 + k] for j >= k; the entries above the
// diagonal are never read) as soon as it is scaled, and the lanes read it
// back as 16-byte broadcasts for their rank-1 updates. The pivots' rsqrt go
// to inv and L11 to S.
template <typename T, bool kSmem>
__device__ __forceinline__ void factor_diagonal(T* S, T* D, T* inv, int m,
                                                int k0, int w, int lane) {
  const T tiny = T(1e-30);
  const bool real = lane < w;
  T a[kNB];
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    T v = (j == lane) ? T(1) : T(0);        // identity rows past w
    if (real && j <= lane) v = S[at<kSmem>(k0 + lane, k0 + j, m)];
    a[j] = v;
  }
  // every lane scales and updates its whole row: the values this leaves
  // above the diagonal are never read, from D or from a[]
#pragma unroll
  for (int k = 0; k < kNB; ++k) {
    const T d = __shfl_sync(0xffffffffu, a[k], k);
    const T iv = rsqrt_t(d > tiny ? d : tiny);
    a[k] *= iv;
    if (lane == k) inv[k] = iv;
    D[k * kNB + lane] = a[k];
    __syncwarp();
#pragma unroll
    for (int c = (k + 1) / 4; c < kNB / 4; ++c) {
      T l[4];
      load4(D + k * kNB + 4 * c, l);        // L[k0 + 4c + v, k0 + k]
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        if (4 * c + v > k) a[4 * c + v] = fma_t(-a[k], l[v], a[4 * c + v]);
      }
    }
  }
  if (real) {
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      if (j <= lane) S[at<kSmem>(k0 + lane, k0 + j, m)] = a[j];
    }
  }
}

// Device-memory variant: the panel's rows r0 <= i < m, S[i, k0:k0+32],
// into Pt transposed (lane j takes column k0 + j, so device memory is read
// row-contiguously), and back once solved.
template <typename T, bool kToPanel>
__device__ __forceinline__ void move_rows(T* S, T* Pt, int m, int sp,
                                          int k0, int r0, int warp,
                                          int lane, int nwarps) {
  for (int i = r0 + warp; i < m; i += nwarps) {
    T& s = S[at<false>(i, k0 + lane, m)];
    T& p = Pt[lane * sp + i];
    if (kToPanel) {
      p = s;
    } else {
      s = p;
    }
  }
}

// B: L[i, k0:k0+32] = S[i, k0:k0+32] L11^-T for the rows r0 <= i < m by
// the right-looking recurrence within the row, one row per thread, with L11
// read from D as 16-byte broadcasts. The row comes from S in shared memory
// and goes to S and Pt; in the device-memory variant it was staged in Pt
// and goes back there.
template <typename T, bool kSmem>
__device__ __forceinline__ void solve_rows(T* S, T* Pt, const T* D,
                                           const T* inv, int m, int sp,
                                           int k0, int r0, int t, int nt) {
  for (int i = r0 + t; i < m; i += nt) {
    T x[kNB];
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      x[j] = kSmem ? S[at<true>(i, k0 + j, m)] : Pt[j * sp + i];
    }
#pragma unroll
    for (int k = 0; k < kNB; ++k) {
      x[k] *= inv[k];
#pragma unroll
      for (int c = (k + 1) / 4; c < kNB / 4; ++c) {
        T l[4];
        load4(D + k * kNB + 4 * c, l);      // L[k0 + 4c + v, k0 + k]
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          if (4 * c + v > k) x[4 * c + v] = fma_t(-x[k], l[v], x[4 * c + v]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      if (kSmem) S[at<true>(i, k0 + j, m)] = x[j];
      Pt[j * sp + i] = x[j];
    }
  }
}

// C: S[i, j] -= sum_k L[i, k0 + k] L[j, k0 + k] for r0 <= j <= i < m, in
// 4 x 4 register tiles over the lower triangle of the trailing block,
// numbered row by row, from tile q0 on (the first 36 tiles cover the next
// panel's diagonal block).
template <typename T, bool kSmem>
__device__ __forceinline__ void update_trailing(T* S, const T* Pt, int m,
                                                int sp, int r0, int q0, int t,
                                                int nt) {
  const int R = (m - r0 + 3) / 4;
  for (int q = q0 + t; q < R * (R + 1) / 2; q += nt) {
    const int I = tri_row(q);
    const int J = q - I * (I + 1) / 2;
    const int ri = r0 + 4 * I;
    const int rj = r0 + 4 * J;
    T acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = T(0);
    }
#pragma unroll 8
    for (int k = 0; k < kNB; ++k) {
      T a[4], b[4];
      load4(Pt + k * sp + ri, a);
      load4(Pt + k * sp + rj, b);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fma_t(a[u], b[v], acc[u][v]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = ri + u;
      if (i >= m) break;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int j = rj + v;
        if (j <= i) S[at<kSmem>(i, j, m)] -= acc[u][v];
      }
    }
  }
}

// C on the next panel's diagonal block only, one entry per thread, so that
// the whole group finishes it quickly and warp 0 can factor the block while
// the other warps run the rest of C.
template <typename T, bool kSmem>
__device__ __forceinline__ void update_next_diagonal(T* S, const T* Pt, int m,
                                                     int sp, int r0, int t,
                                                     int nt) {
  const int w = min(m - r0, kNB);
  for (int e = t; e < w * (w + 1) / 2; e += nt) {
    const int i = tri_row(e);
    const int j = e - i * (i + 1) / 2;
    T acc = T(0);
#pragma unroll 8
    for (int k = 0; k < kNB; ++k) {
      acc = fma_t(Pt[k * sp + r0 + i], Pt[k * sp + r0 + j], acc);
    }
    S[at<kSmem>(r0 + i, r0 + j, m)] -= acc;
  }
}

constexpr int kCopyUnroll = 8;     // independent loads in flight a thread

// One instantiation per variant, so that the compiler knows which memory
// each pointer addresses (a pointer that is shared in one launch and
// global in another would make every panel access a generic one).
template <typename T, int kVariant, int kMinBlocks>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
chol_kernel(const T* __restrict__ A, T* __restrict__ L, T* scratch, int B,
            int m, int group_threads) {
  constexpr bool kSmem = kVariant == kShared;
  constexpr int kDiagTiles = (kNB / 4) * (kNB / 4 + 1) / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int group = threadIdx.x / group_threads;
  const int t = threadIdx.x - group * group_threads;
  const long long b =
      static_cast<long long>(blockIdx.x) * (blockDim.x / group_threads) +
      group;
  if (b >= B) return;                 // the whole group leaves together
  const int warp = t >> 5;
  const int lane = t & 31;
  const int nwarps = group_threads >> 5;
  const int bar = group;             // the group's named barrier
  const int sp = panel_stride(m);
  const size_t mm = static_cast<size_t>(m) * m;
  const T* Ab = A + b * mm;
  T* Lb = L + b * mm;

  unsigned char* base =
      smem_raw + group * group_bytes(m, sizeof(T), kVariant);
  const size_t tri =
      kSmem ? round16(static_cast<size_t>(m) * (m + 1) / 2 * sizeof(T)) : 0;
  T* S = kSmem ? reinterpret_cast<T*>(base) : Lb;
  T* Pt = kVariant == kDevicePanel ? scratch + b * panel_elems(m)
                                   : reinterpret_cast<T*>(base + tri);
  T* D = Pt + kNB * sp;
  T* inv = D + kNB * kNB;

  // lower triangle of A into S, kCopyUnroll loads in flight a thread (the
  // device-memory variant writes the zeros above it straight to L)
  const int n_in = kSmem ? m * (m + 1) / 2 : m * m;
  for (int q0 = t; q0 < n_in; q0 += kCopyUnroll * group_threads) {
    T v[kCopyUnroll];
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u) {
      const int q = q0 + u * group_threads;
      int i = 0, j = 0;
      if (kSmem) {
        i = tri_row(q);
        j = q - i * (i + 1) / 2;
      } else {
        i = q / m;
        j = q - i * m;
      }
      v[u] = q < n_in && j <= i ? Ab[static_cast<size_t>(i) * m + j] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u) {
      const int q = q0 + u * group_threads;
      if (q < n_in) S[q] = v[u];
    }
  }
  for (int idx = t; idx < kNB * (sp - m); idx += group_threads) {
    Pt[(idx / (sp - m)) * sp + m + idx % (sp - m)] = T(0);
  }
  bar_sync(bar, group_threads);

  if (warp == 0) factor_diagonal<T, kSmem>(S, D, inv, m, 0, min(m, kNB), lane);
  bar_sync(bar, group_threads);
  for (int k0 = 0; k0 + kNB < m; k0 += kNB) {
    const int r0 = k0 + kNB;
    if (!kSmem) {
      move_rows<T, true>(S, Pt, m, sp, k0, r0, warp, lane, nwarps);
      bar_sync(bar, group_threads);
    }
    solve_rows<T, kSmem>(S, Pt, D, inv, m, sp, k0, r0, t, group_threads);
    bar_sync(bar, group_threads);
    if (!kSmem) move_rows<T, false>(S, Pt, m, sp, k0, r0, warp, lane, nwarps);
    if (nwarps == 1) {                // one warp: the update, then A
      update_trailing<T, kSmem>(S, Pt, m, sp, r0, 0, t, group_threads);
      __syncwarp();
    } else {
      update_next_diagonal<T, kSmem>(S, Pt, m, sp, r0, t, group_threads);
      bar_sync(bar, group_threads);
      if (warp > 0) {
        update_trailing<T, kSmem>(S, Pt, m, sp, r0, kDiagTiles, t - 32,
                                  group_threads - 32);
      }
    }
    if (warp == 0) {
      factor_diagonal<T, kSmem>(S, D, inv, m, r0, min(m - r0, kNB), lane);
    }
    bar_sync(bar, group_threads);
  }

  if (kSmem) {                        // L out, zeros above the diagonal
#pragma unroll 4
    for (int q = t; q < m * m; q += group_threads) {
      const int i = q / m;
      const int j = q - i * m;
      Lb[q] = j <= i ? S[at<true>(i, j, m)] : T(0);
    }
  }
}

template <typename T, int kVariant>
cudaError_t launch_variant(const T* A, T* L, T* scratch, int B, int m,
                           int group_threads, int blocks_per_cta,
                           int smem_bytes, cudaStream_t stream) {
  // f32 in device memory: at most 64 registers a thread, so 1024 threads
  // an SM hide the device-memory latency; else at most 128 (512 threads)
  constexpr int kMinBlocks = sizeof(T) == 4 && kVariant != kShared ? 2 : 1;
  auto kernel = chol_kernel<T, kVariant, kMinBlocks>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const unsigned grid =
      static_cast<unsigned>((B + blocks_per_cta - 1) / blocks_per_cta);
  kernel<<<grid, group_threads * blocks_per_cta, smem_bytes, stream>>>(
      A, L, scratch, B, m, group_threads);
  return cudaGetLastError();
}

// Launch the plan (variant, threads per block, blocks per CTA, dynamic
// shared bytes) that ops/chol.py::launch_plan computed; a plan this file
// would lay out differently is refused before the launch.
template <typename T>
int launch(const T* A, T* L, T* scratch, int B, int m, int variant,
           int group_threads, int blocks_per_cta, int smem_bytes,
           void* stream) {
  if (B <= 0 || m <= 0 || variant < kDevice || variant > kDevicePanel ||
      (variant == kDevicePanel) != (scratch != nullptr) ||
      group_threads < 32 || group_threads % 32 != 0 || blocks_per_cta < 1 ||
      blocks_per_cta > kMaxGroups ||
      group_threads * blocks_per_cta > kMaxThreads ||
      static_cast<size_t>(smem_bytes) !=
          blocks_per_cta * group_bytes(m, sizeof(T), variant)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (variant == kShared) {
    err = launch_variant<T, kShared>(A, L, scratch, B, m, group_threads,
                                     blocks_per_cta, smem_bytes, s);
  } else if (variant == kDevice) {
    err = launch_variant<T, kDevice>(A, L, scratch, B, m, group_threads,
                                     blocks_per_cta, smem_bytes, s);
  } else {
    err = launch_variant<T, kDevicePanel>(A, L, scratch, B, m,
                                          group_threads, blocks_per_cta,
                                          smem_bytes, s);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Factor B row-major (m, m) blocks of A into L (distinct buffers) on
// `stream` with the given plan: variant 1 keeps each block in shared
// memory, 0 works in place in L with the panel in shared memory, 2 also
// keeps the panel in `scratch` (B * (32 * (round4(m) + 64) + 64) elements,
// 16-byte aligned; unused otherwise); group_threads per block;
// blocks_per_cta blocks per CTA; smem_bytes of dynamic shared memory per
// CTA. Returns the cudaError_t of the launch (0 on success).
int george_chol_f32(const float* A, float* L, float* scratch, int B, int m,
                    int variant, int group_threads, int blocks_per_cta,
                    int smem_bytes, void* stream) {
  return launch<float>(A, L, scratch, B, m, variant, group_threads,
                       blocks_per_cta, smem_bytes, stream);
}

int george_chol_f64(const double* A, double* L, double* scratch, int B,
                    int m, int variant, int group_threads,
                    int blocks_per_cta, int smem_bytes, void* stream) {
  return launch<double>(A, L, scratch, B, m, variant, group_threads,
                        blocks_per_cta, smem_bytes, stream);
}

// The tiled entry point (the counterpart of pallas_cholesky): the same
// kernel and contract; ops/chol.py gives it the tiled launch plan.
int george_chol_tile_f32(const float* A, float* L, float* scratch, int B,
                         int m, int variant, int group_threads,
                         int blocks_per_cta, int smem_bytes, void* stream) {
  return launch<float>(A, L, scratch, B, m, variant, group_threads,
                       blocks_per_cta, smem_bytes, stream);
}

int george_chol_tile_f64(const double* A, double* L, double* scratch, int B,
                         int m, int variant, int group_threads,
                         int blocks_per_cta, int smem_bytes, void* stream) {
  return launch<double>(A, L, scratch, B, m, variant, group_threads,
                        blocks_per_cta, smem_bytes, stream);
}

// The current device's limits that the launch plan reads: out[0] the
// opt-in shared bytes per CTA, out[1] the shared bytes per SM, out[2] the
// SM count. Returns the cudaError_t of the queries.
int george_chol_device_limits(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &out[0], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &out[1], cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&out[2], cudaDevAttrMultiProcessorCount,
                                 dev);
  }
  return static_cast<int>(err);
}

}  // extern "C"
