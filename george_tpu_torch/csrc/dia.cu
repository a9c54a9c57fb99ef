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
// What bounds it: device memory. One pass reads the value table (n*D
// words), Y and diag once and writes out once: at n = 2e5, D = 301, f32 the
// table alone is 241 MB (more than the 50 MB L2), about r/2 flop per byte
// against a float32 ridge near 20 (67 TFLOP/s over 3.35 TB/s). Short of
// that, two things held the first version back: the table arrived by
// 4-byte loads made right before their use, and with several columns
// every FMA took a shared-memory load of its own, so the shared-memory pipe
// and not the table stream set the pace. This version measures, on an
// H100 (700 W) at that band, 0.088 ms of device time a call at r = 1 (bound
// 0.073) and 0.143 ms at r = 16 (bound 0.080); PERF.md keeps the record.
//
// Design (the streaming kernel, dia_stream_kernel):
//   * the table is an asynchronous stream. A tile of tile_rows consecutive
//     rows is one contiguous run of tile_rows * D words; with tile_rows a
//     multiple of 16 bytes' worth of elements every tile starts and ends
//     16-byte aligned whatever D is, so one thread brings it into a ring
//     of `stages` shared-memory buffers with cp.async.bulk (the 1-D TMA
//     copy), each completing on its own mbarrier. `stages` tiles are in
//     flight per CTA while the CTA's threads work on the tile that has
//     arrived; no lane loads the table itself. The ragged last tile
//     (and a table whose base is not 16-byte aligned) comes by ordinary
//     loads;
//   * a persistent grid: each CTA walks over items of tiles_per_item
//     consecutive tiles with a stride of gridDim.x, and refills a stage as
//     soon as the CTA has left it, so the ring stays full across tiles and
//     items. Nothing is carried between tiles but the ring's phase;
//   * Y's window of an item (rows item_row0 + d_min .. + item_rows + D - 2,
//     zero outside [0, n)) is staged once per item, row-major as Y is in
//     device memory (no transposing gather), padded to a row stride that
//     keeps the 16-byte loads below free of bank conflicts;
//   * register tiling: a thread owns R consecutive rows, C consecutive
//     columns and one of NSEG segments of the band. At diagonal step s it
//     loads one window row Y[i + s, c .. c + C) (one 16-byte load per four
//     floats) and R table entries v[i + a, s - a] from the staged tile and
//     does R * C FMAs: one shared-memory load feeds several FMAs
//     instead of one. The NSEG partial sums of a row meet in a
//     reduce-scatter over warp shuffles (each step halves what is
//     exchanged), after which every lane owns R * C / NSEG finished
//     outputs; diag[i] * Y[i, c] is added on the way out;
//   * any r: ceil(r / C) column groups, spread over the CTA's thread
//     groups in one pass when they fit (r = 17 is five groups of four, the
//     last one mostly zero padding), else in several passes over the
//     staged tile, never over device memory. r = 1 is the R = C = 1
//     instantiation of the same kernel on the same stream;
//   * the launch geometry (tile rows, stages, tiles per item, segment
//     length, window stride, threads, CTAs) is computed once in Python
//     (ops/dia.py::launch_plan) and passed in; george_dia_prepare raises
//     the dynamic shared-memory limit of every instantiation once per
//     device, so a launch makes no other runtime call;
//   * 64-bit indexing for i * D and i * r.
// A second, plain kernel (dia_device_kernel) reads Y through L2 from device
// memory, one warp per row; the plan takes it only when even the smallest
// ring and window exceed shared memory (a very wide band times many
// columns). It is kept simple, not fast.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxThreads = 512;   // the streaming kernel's launch bound
constexpr int kMaxStages = 8;

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// ---------------------------------------------------------------------------
// mbarrier and bulk-copy primitives (PTX)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Wait until the barrier's phase differs from `parity`. A wait that lasts
// seconds means a broken pipeline: trap, so that the launch ends in an
// error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > 8000000000LL) {
      __trap();
    }
  }
}

// ---------------------------------------------------------------------------
// the streaming kernel
// ---------------------------------------------------------------------------

struct StreamArgs {
  long long n;
  int D, d_min, r;
  int tile_rows;    // rows of one table tile (one ring stage)
  int stages;       // ring depth
  int tiles;        // tiles per item (one window of Y)
  int seg_len;      // diagonals per band segment
  int stride;       // window row stride, in elements
  int groups;       // column groups worked at once (thread groups per row tile)
  int passes;       // passes over a staged tile: ceil(col groups / groups)
  int win_off;      // byte offsets into dynamic shared memory
  int ring_off;
  int stage_bytes;
  int bulk;         // 1: vals is 16-byte aligned, full tiles come by bulk copy
};

// C consecutive elements of shared memory, by 16-byte loads where they line
// up (the plan keeps the window stride and the column tile so).
template <typename T, int C>
__device__ __forceinline__ void load_cols(const T* p, T (&v)[C]) {
  if constexpr ((C * sizeof(T)) % 16 == 0) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int k = 0; k < C / kPer; ++k) {
      const uint4 q = reinterpret_cast<const uint4*>(p)[k];
      const T* e = reinterpret_cast<const T*>(&q);
#pragma unroll
      for (int t = 0; t < kPer; ++t) v[k * kPer + t] = e[t];
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = p[c];
  }
}

// One diagonal step s of a thread's R x C tile: window row s against the
// table entries v[a, s - a]. kGuard: s - a may leave the segment [j0, j1).
template <typename T, int R, int C, bool kGuard>
__device__ __forceinline__ void band_step(T (&acc)[R][C], const T* vt,
                                          const T* wp, int s, int D,
                                          int stride, int j0, int j1) {
  T yv[C];
  load_cols<T, C>(wp + static_cast<size_t>(s) * stride, yv);
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int j = s - a;
    if (!kGuard || (j >= j0 && j < j1)) {
      const T v = vt[a * D + j];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[a][c] = fma_t(v, yv[c], acc[a][c]);
    }
  }
}

template <typename T, int R, int C, int NSEG>
__global__ void __launch_bounds__(kMaxThreads)
dia_stream_kernel(const T* __restrict__ vals, const T* __restrict__ diag,
                  const T* __restrict__ y, T* __restrict__ out,
                  const StreamArgs a) {
  static_assert((NSEG & (NSEG - 1)) == 0 && NSEG <= 32, "NSEG: power of 2");
  constexpr int V = R * C;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  T* win = reinterpret_cast<T*>(smem + a.win_off);
  unsigned char* ring = smem + a.ring_off;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const long long n = a.n;
  const int D = a.D, r = a.r, TR = a.tile_rows;
  const int M = a.tiles * TR;            // rows of one item
  const int W = M + D - 1;               // rows of its window
  const long long nitems = (n + M - 1) / M;
  const size_t stage_elems = static_cast<size_t>(TR) * D;

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) mbar_init(smem_u32(bars + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the padding columns of the window stay zero for the kernel's lifetime
  for (int e = tid; e < W * a.stride; e += nthreads) win[e] = T(0);
  __syncthreads();

  // thread 0: start the bulk copy of this CTA's m-th tile, if it is a full
  // tile of an aligned table (any other tile comes by ordinary loads)
  auto start_copy = [&](int m) {
    if (!a.bulk) return;
    const long long item =
        blockIdx.x + static_cast<long long>(m / a.tiles) * gridDim.x;
    if (item >= nitems) return;
    const long long row0 = item * M + static_cast<long long>(m % a.tiles) * TR;
    if (row0 + TR > n) return;
    const int s = m % a.stages;
    const uint32_t bar = smem_u32(bars + s);
    mbar_expect_tx(bar, static_cast<uint32_t>(a.stage_bytes));
    bulk_load(smem_u32(ring + static_cast<size_t>(s) * a.stage_bytes),
              vals + row0 * D, static_cast<uint32_t>(a.stage_bytes), bar);
  };
  if (tid == 0) {
    for (int m = 0; m < a.stages; ++m) start_copy(m);
  }

  // this thread's place: band segment, column group, row group
  const int seg = tid % NSEG;
  const int grp = tid / NSEG;
  const int cgl = grp % a.groups;
  const int lrow = (grp / a.groups) * R;     // first row, within the tile
  const int lane = tid & 31;
  const unsigned gmask =
      NSEG == 32 ? 0xffffffffu
                 : (((1u << NSEG) - 1u) << (lane & ~(NSEG - 1)));
  // the band is cut into NSEG segments of diagonals, the same count for
  // every lane of a warp (cutting the sweep over window rows instead
  // saves the 2 (R - 1) guarded steps per segment but leaves only the
  // first and last segment with guards, and the warp then pays for both:
  // measured 17% slower)
  const int j0 = seg * a.seg_len;
  const int j1 = min(D, j0 + a.seg_len);
  // the reduce-scatter below leaves a lane kKeep outputs of its R x C tile,
  // from flat index obase on (a pure function of its segment); with more
  // segments than outputs the lanes of the spare bits hold copies
  constexpr int kKeep = V >= NSEG ? V / NSEG : 1;
  int obase = 0;
  bool writer = true;
  {
    int have = V;
#pragma unroll
    for (int bit = 1; bit < NSEG; bit <<= 1) {
      if (have > 1) {
        have >>= 1;
        if (seg & bit) obase += have;
      } else if (seg & bit) {
        writer = false;
      }
    }
  }
  constexpr int kVec = 16 / sizeof(T);
  const bool vec_y = (r % kVec == 0) &&
                     (reinterpret_cast<uintptr_t>(y) % 16 == 0);

  long long item = blockIdx.x;
  int sub = 0, stage = 0;
  uint32_t parity = 0;
  for (int m = 0;; ++m) {
    if (item >= nitems) break;
    const long long row0 = item * M + static_cast<long long>(sub) * TR;
    if (row0 >= n) break;
    const bool full = a.bulk && (row0 + TR <= n);
    T* tile = reinterpret_cast<T*>(ring +
                                   static_cast<size_t>(stage) * a.stage_bytes);

    if (sub == 0) {
      // stage the item's window of Y (every thread left the last one at
      // the barrier that closed the previous tile)
      const long long g0 = item * M + a.d_min;
      if (vec_y) {
        const int rv = r / kVec;
        for (int e = tid; e < W * rv; e += nthreads) {
          const int w = e / rv;
          const int cv = e - w * rv;
          const long long g = g0 + w;
          uint4 q = make_uint4(0u, 0u, 0u, 0u);
          if (g >= 0 && g < n) {
            q = *reinterpret_cast<const uint4*>(y + g * r + cv * kVec);
          }
          *reinterpret_cast<uint4*>(win + static_cast<size_t>(w) * a.stride +
                                    cv * kVec) = q;
        }
      } else {
        for (int e = tid; e < W * r; e += nthreads) {
          const int w = e / r;
          const int c = e - w * r;
          const long long g = g0 + w;
          win[static_cast<size_t>(w) * a.stride + c] =
              (g >= 0 && g < n) ? y[g * r + c] : T(0);
        }
      }
    }
    if (!full) {
      const long long left = n - row0;
      const int count = static_cast<int>((left < TR ? left : TR) * D);
      const T* src = vals + row0 * D;
      for (int e = tid; e < count; e += nthreads) tile[e] = src[e];
    }
    if (sub == 0 || !full) __syncthreads();
    if (full) mbar_wait(smem_u32(bars + stage), parity);

    for (int p = 0; p < a.passes; ++p) {
      const int cg = p * a.groups + cgl;
      if (cg * C >= r) continue;            // uniform over a segment group
      T acc[R][C];
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = T(0);
      }
      if (j1 > j0) {
        const T* vt = tile + static_cast<size_t>(lrow) * D;
        const T* wp =
            win + static_cast<size_t>(sub * TR + lrow) * a.stride + cg * C;
        const int send = j1 + R - 1;
        int s = j0;
        if (R > 1) {
          const int head = min(j0 + R - 1, send);
          for (; s < head; ++s) {
            band_step<T, R, C, true>(acc, vt, wp, s, D, a.stride, j0, j1);
          }
        }
#pragma unroll 4
        for (; s < j1; ++s) {
          band_step<T, R, C, false>(acc, vt, wp, s, D, a.stride, j0, j1);
        }
        if (R > 1) {
          for (; s < send; ++s) {
            band_step<T, R, C, true>(acc, vt, wp, s, D, a.stride, j0, j1);
          }
        }
      }

      // the segments' partial sums meet: each step sends one half of what
      // a lane still holds to its partner and keeps the other
      T x[V];
#pragma unroll
      for (int i = 0; i < V; ++i) x[i] = acc[i / C][i % C];
      int have = V;
#pragma unroll
      for (int bit = 1; bit < NSEG; bit <<= 1) {
        const bool up = (seg & bit) != 0;
        if (have > 1) {
          have >>= 1;
#pragma unroll
          for (int i = 0; i < V / 2; ++i) {
            if (i < have) {
              const T send_v = up ? x[i] : x[i + have];
              const T keep_v = up ? x[i + have] : x[i];
              x[i] = keep_v + __shfl_xor_sync(gmask, send_v, bit);
            }
          }
        } else {
          x[0] += __shfl_xor_sync(gmask, x[0], bit);
        }
      }
      // what this lane owns after the reduction, with diag * y added (asking
      // for diag and y before the band sweep measured 5% slower)
      long long oidx[kKeep];
      T dy[kKeep];
#pragma unroll
      for (int i = 0; i < kKeep; ++i) {
        const int idx = obase + i;
        const long long row = row0 + lrow + idx / C;
        const int col = cg * C + idx % C;
        const bool mine = writer && row < n && col < r;
        oidx[i] = mine ? row * r + col : -1;
        dy[i] = mine ? diag[row] * y[row * r + col] : T(0);
      }
#pragma unroll
      for (int i = 0; i < kKeep; ++i) {
        if (oidx[i] >= 0) out[oidx[i]] = x[i] + dy[i];
      }
    }

    __syncthreads();                 // the CTA has left this stage
    if (tid == 0) start_copy(m + a.stages);
    if (++stage == a.stages) {
      stage = 0;
      parity ^= 1u;
    }
    if (++sub == a.tiles) {
      sub = 0;
      item += gridDim.x;
    }
  }
}

// ---------------------------------------------------------------------------
// the device-memory kernel: one warp per row, Y read through L2
// ---------------------------------------------------------------------------

constexpr int kDevWarps = 8;
constexpr int kDevRows = 128;      // rows per CTA, 16 per warp
constexpr int kDevCols = 16;       // columns accumulated per pass over a row

template <typename T>
__global__ void __launch_bounds__(kDevWarps * 32)
dia_device_kernel(const T* __restrict__ vals, const T* __restrict__ diag,
                  const T* __restrict__ y, T* __restrict__ out, long long n,
                  int D, int d_min, int r) {
  const long long i0 = static_cast<long long>(blockIdx.x) * kDevRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int row = warp; row < kDevRows; row += kDevWarps) {
    const long long i = i0 + row;
    if (i >= n) break;
    const T* vrow = vals + i * D;
    for (int c0 = 0; c0 < r; c0 += kDevCols) {
      const int rc = (r - c0 < kDevCols) ? r - c0 : kDevCols;
      T acc[kDevCols];
#pragma unroll
      for (int c = 0; c < kDevCols; ++c) acc[c] = T(0);
      for (int j = lane; j < D; j += 32) {
        const T v = vrow[j];
        const long long g = i + d_min + j;
        if (g >= 0 && g < n) {
          const T* yp = y + g * r + c0;
#pragma unroll
          for (int c = 0; c < kDevCols; ++c) {
            if (c < rc) acc[c] = fma_t(v, yp[c], acc[c]);
          }
        }
      }
      T mine = T(0);
#pragma unroll
      for (int c = 0; c < kDevCols; ++c) {
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

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// The instantiations of the streaming kernel: X(type, R, C, NSEG). One
// column (R = C = 1) and 4 rows x 16 bytes of columns a thread, each with
// 8, 16 or 32 band segments (the plan takes more segments when few column
// groups or a short tile would leave a CTA few threads).
#define GEORGE_DIA_STREAM_KERNELS(X) \
  X(float, 1, 1, 8)                  \
  X(float, 1, 1, 16)                 \
  X(float, 1, 1, 32)                 \
  X(float, 4, 4, 8)                  \
  X(float, 4, 4, 16)                 \
  X(float, 4, 4, 32)                 \
  X(double, 1, 1, 8)                 \
  X(double, 1, 1, 16)                \
  X(double, 1, 1, 32)                \
  X(double, 4, 2, 8)                 \
  X(double, 4, 2, 16)                \
  X(double, 4, 2, 32)

template <typename T>
int launch(const T* vals, const T* diag, const T* y, T* out, long long n,
           int D, int d_min, int r, const int* plan, cudaStream_t stream) {
  if (n < 0 || D <= 0 || r < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || r == 0) return 0;
  // plan: variant, row tile, column tile, segments, then StreamArgs' fields
  // from tile_rows on, then bulk, shared bytes, threads, grid
  const int variant = plan[0], R = plan[1], C = plan[2], NSEG = plan[3];
  const int smem = plan[15], threads = plan[16], grid = plan[17];
  if (variant == 0) {
    dia_device_kernel<T><<<grid, threads, 0, stream>>>(vals, diag, y, out, n,
                                                       D, d_min, r);
    return static_cast<int>(cudaGetLastError());
  }
  StreamArgs a;
  a.n = n;
  a.D = D;
  a.d_min = d_min;
  a.r = r;
  a.tile_rows = plan[4];
  a.stages = plan[5];
  a.tiles = plan[6];
  a.seg_len = plan[7];
  a.stride = plan[8];
  a.groups = plan[9];
  a.passes = plan[10];
  a.win_off = plan[11];
  a.ring_off = plan[12];
  a.stage_bytes = plan[13];
  a.bulk = plan[14];
  if (a.stages < 1 || a.stages > kMaxStages || threads > kMaxThreads ||
      a.tile_rows % R != 0 ||
      threads != NSEG * a.groups * (a.tile_rows / R)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define GEORGE_DIA_GO(TYPE, RR, CC, NS)                                      \
  if constexpr (std::is_same<T, TYPE>::value) {                              \
    if (R == RR && C == CC && NSEG == NS) {                                  \
      dia_stream_kernel<T, RR, CC, NS><<<grid, threads, smem, stream>>>(     \
          vals, diag, y, out, a);                                            \
      return static_cast<int>(cudaGetLastError());                           \
    }                                                                        \
  }
  GEORGE_DIA_STREAM_KERNELS(GEORGE_DIA_GO)
#undef GEORGE_DIA_GO
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// out = (band(vals) + diag) * y for row-major vals (n, D), diag (n,),
// y and out (n, r) (distinct buffers), band offsets d_min .. d_min + D - 1,
// on `stream`, with the launch plan of ops/dia.py::launch_plan as 18 ints.
// Returns the cudaError_t of the launch (0 on success).
int george_dia_f32(const float* vals, const float* diag, const float* y,
                   float* out, long long n, int D, int d_min, int r,
                   const int* plan, void* stream) {
  return launch<float>(vals, diag, y, out, n, D, d_min, r, plan,
                       static_cast<cudaStream_t>(stream));
}

int george_dia_f64(const double* vals, const double* diag, const double* y,
                   double* out, long long n, int D, int d_min, int r,
                   const int* plan, void* stream) {
  return launch<double>(vals, diag, y, out, n, D, d_min, r, plan,
                        static_cast<cudaStream_t>(stream));
}

// Once per device, before the first launch there: let every instantiation
// of the streaming kernel take the device's opt-in shared memory.
int george_dia_prepare(void) {
  int dev = 0, bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return static_cast<int>(err);
#define GEORGE_DIA_ATTR(TYPE, RR, CC, NS)                                  \
  err = cudaFuncSetAttribute(dia_stream_kernel<TYPE, RR, CC, NS>,          \
                             cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                             bytes);                                       \
  if (err != cudaSuccess) return static_cast<int>(err);
  GEORGE_DIA_STREAM_KERNELS(GEORGE_DIA_ATTR)
#undef GEORGE_DIA_ATTR
  return 0;
}

}  // extern "C"
