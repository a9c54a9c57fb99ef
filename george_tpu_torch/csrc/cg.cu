// One step of Jacobi-preconditioned conjugate gradients on a block of
// right-hand sides, after the apply AP = (K + diag) P, for the sparse
// solver's cg_solve (george_tpu_torch/solvers/sparse.py).
//
// What it computes, per column c of the row-major (n, r) blocks X, R, P,
// AP, with minv = 1 / the Jacobi preconditioner (n,), the per-column
// rz = sum R * Z and b2 = max(sum B * B, tiny) (r,), and the int32 pair
// state = [done, it]:
//   denom = sum P * AP;          alpha = rz / (denom > 0 ? denom : 1)
//   X += alpha P;  R -= alpha AP;  Z = minv R
//   rz' = sum R * Z;             P = Z + (rz' / (rz > 0 ? rz : 1)) P
//   rz = rz';  it += 1;  done = it >= maxiter or no column has
//   sum R * R / b2 > tol2
// and nothing at all when it finds done set: X, R, P, rz and state stay as
// they are, so steps launched after the stop are wasted work, never a
// different answer. That is ops/cg.py::cg_step_plain, today's loop body of
// solvers/sparse.py::pcg_solve with its stopping test, in the same order.
//
// Replaces no Pallas kernel: the JAX package runs this loop body inside
// lax.while_loop (george_tpu/solvers/sparse.py::pcg_solve), where XLA fuses
// the updates and reductions and the stopping test never leaves the device.
// Eager torch ran it as some twenty kernels and a host read an iteration.
//
// What bounds it: device memory. At the least a step reads P, AP, X, R
// and minv and writes X, R and P once (6.4 MB at n = 2e5, r = 1, f32, 1.9
// us at 3.35 TB/s; 90 MB at r = 16, 27 us). Three column sums, each needed
// by what follows it, part the step into three passes that read P and AP
// twice and R three times; on an H100 (700 W) a step takes 20.4-20.9 us at
// r = 1 and 54.9-55.2 us at r = 16 (PERF.md keeps the record). The design:
//   * one cooperative launch a step: the grid is no larger than the blocks
//     that can be resident at once (cudaLaunchCooperativeKernel refuses
//     more), so a grid-wide barrier between the sums is safe. Three
//     phases: P.AP; then alpha, the X/R updates and R.Z, R.R; then beta
//     and the P update. Z is never stored: minv * R is recomputed where P
//     needs it, from the R this thread wrote;
//   * a block owns whole rows: its threads are (row, column) pairs over
//     min(r, kThreads) columns, so that a thread's column is fixed and its
//     sums need no atomics. Each block reduces its rows per column (by warp
//     shuffles where the columns divide a warp, else a tree in shared
//     memory) and writes one float64 partial per column; after the barrier
//     every block sums the grid's partials in the same fixed order, so
//     every block gets the same bits of alpha and beta, and two runs give
//     the same answer. The sums accumulate in float64 and are rounded to
//     the working type where the plain version has them in it;
//   * the phases walk a thread's rows in alternating directions, so that
//     each starts on the rows the one before it touched last, still in L2
//     (at r = 16 the four blocks, 51 MB in float32, just exceed it);
//   * the only values shared between blocks are the partials (read
//     through L2 with ld.global.cg) and rz and state, which every block
//     reads before the first barrier and block 0 writes after the last;
//   * the grid barrier is a counter that flips its top bit once every
//     block has arrived (the arrival arithmetic of cooperative groups'
//     grid sync), kept in the first word of the caller's workspace and
//     zeroed once when that is made; a barrier that waits for seconds
//     traps, so a broken launch ends in an error instead of a hung card.
// The launch geometry (grid, shared bytes) comes from george_cg_plan, once
// per shape (ops/cg.py); a launch makes no other runtime call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;          // a block
constexpr long long kBarrierCycles = 8000000000LL;

template <typename T>
struct StepArgs {
  T* X;
  T* R;
  T* P;
  const T* AP;
  const T* minv;
  T* rz;
  const T* b2;
  int* state;          // [done, it]
  double* work;        // barrier word, then 3 * gridDim.x * r partials
  long long n;
  int r;
  double tol2;
  int maxiter;
};

// Every block of the (co-resident) grid arrives before any leaves.
__device__ __forceinline__ void grid_sync(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    // blocks 1.. add 1, block 0 adds 2^31 - (blocks - 1): the last arrival
    // flips the top bit, and the low bits return to where they were
    unsigned int add = 1;
    if (blockIdx.x == 0) add = 0x80000000u - (gridDim.x - 1);
    __threadfence();
    const unsigned int old = atomicAdd(bar, add);
    const long long start = clock64();
    while (((old ^ *reinterpret_cast<volatile unsigned int*>(bar)) &
            0x80000000u) == 0) {
      if (clock64() - start > kBarrierCycles) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// The sums over a block's rows of a and b for this thread's column: the
// threads are (row lr < rows, column lc < cols) at threadIdx.x = lr * cols
// + lc; `on` marks those that hold a value. Every thread of the column
// gets the totals, summed in the same order in every block. Where cols
// divides a warp, the lanes of one column add by shuffles, then one thread
// a column adds the warps' sums; otherwise a tree over the rows in shared
// memory.
__device__ __forceinline__ void column_sums(double& a, double& b, double* sa,
                                            double* sb, int lr, int lc,
                                            int rows, int cols, bool on) {
  const int t = threadIdx.x;
  if (32 % cols == 0) {
    if (!on) {
      a = 0.0;
      b = 0.0;
    }
    for (int off = 16; off >= cols; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      b += __shfl_xor_sync(0xffffffffu, b, off);
    }
    const int warp = t >> 5, lane = t & 31;
    if (lane < cols) {
      sa[warp * cols + lane] = a;
      sb[warp * cols + lane] = b;
    }
    __syncthreads();
    if (t < cols) {
      double ta = 0.0, tb = 0.0;
      for (int w = 0; w < kThreads / 32; ++w) {
        ta += sa[w * cols + t];
        tb += sb[w * cols + t];
      }
      sa[t] = ta;
      sb[t] = tb;
    }
    __syncthreads();
  } else {
    if (on) {
      sa[t] = a;
      sb[t] = b;
    }
    __syncthreads();
    int top = 1;
    while (top < rows) top <<= 1;
    for (int s = top >> 1; s > 0; s >>= 1) {
      if (on && lr < s && lr + s < rows) {
        sa[t] += sa[t + s * cols];
        sb[t] += sb[t + s * cols];
      }
      __syncthreads();
    }
  }
  a = sa[lc];
  b = sb[lc];
  __syncthreads();                     // the buffers serve the next sums
}

// Sum a column's partials (stride `stride` per block) over the grid, the
// threads of the column splitting the blocks, then over those threads.
__device__ __forceinline__ void grid_sums(const double* pa, const double* pb,
                                          int stride, int c, double& a,
                                          double& b, double* sa, double* sb,
                                          int lr, int lc, int rows, int cols,
                                          bool on) {
  a = 0.0;
  b = 0.0;
  if (on) {
    for (int g = lr; g < static_cast<int>(gridDim.x); g += rows) {
      a += __ldcg(pa + static_cast<long long>(g) * stride + c);
      if (pb) b += __ldcg(pb + static_cast<long long>(g) * stride + c);
    }
  }
  column_sums(a, b, sa, sb, lr, lc, rows, cols, on);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) cg_step_kernel(StepArgs<T> a) {
  // a stopped solve: every block sees the same flag (block 0 writes it
  // only after the last barrier) and leaves before any barrier
  if (a.state[0] != 0) return;

  extern __shared__ __align__(16) unsigned char smem[];
  double* sa = reinterpret_cast<double*>(smem);
  double* sb = sa + kThreads;
  T* s_alpha = reinterpret_cast<T*>(sb + kThreads);
  T* s_rz = s_alpha + a.r;
  T* s_beta = s_rz + a.r;
  __shared__ int s_above;

  const int r = a.r;
  const int cols = r < kThreads ? r : kThreads;
  const int rows = kThreads / cols;
  const int lr = threadIdx.x / cols, lc = threadIdx.x % cols;
  const bool row_on = lr < rows;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows + lr;
  const long long row_step = static_cast<long long>(gridDim.x) * rows;
  const long long n = a.n;
  // this thread's rows are row0 + k * row_step, k < nrow; phases 1 and 3
  // walk them backwards and phase 2 forwards, so that each phase starts on
  // the rows the one before it (or the apply, which ends on the last rows)
  // touched last, while they are still in L2
  const long long nrow = row0 < n ? (n - 1 - row0) / row_step + 1 : 0;
  unsigned int* bar = reinterpret_cast<unsigned int*>(a.work);
  double* part0 = a.work + 1;                                 // (grid, r)
  double* part1 = part0 + static_cast<long long>(gridDim.x) * r;  // 2r each
  if (threadIdx.x == 0) s_above = 0;

  // phase 1: this block's P . AP per column
  for (int c0 = 0; c0 < r; c0 += cols) {
    const int c = c0 + lc;
    const bool on = row_on && c < r;
    double pap = 0.0, unused = 0.0;
    if (on) {
      for (long long k = nrow - 1; k >= 0; --k) {
        const long long e = (row0 + k * row_step) * r + c;
        pap += static_cast<double>(a.P[e]) * static_cast<double>(a.AP[e]);
      }
    }
    column_sums(pap, unused, sa, sb, lr, lc, rows, cols, on);
    if (on && lr == 0) part0[static_cast<long long>(blockIdx.x) * r + c] = pap;
  }
  grid_sync(bar);

  // phase 2: alpha, then X += alpha P, R -= alpha AP and this block's
  // R . Z and R . R per column
  for (int c0 = 0; c0 < r; c0 += cols) {
    const int c = c0 + lc;
    const bool on = row_on && c < r;
    double denom, unused;
    grid_sums(part0, nullptr, r, c, denom, unused, sa, sb, lr, lc, rows, cols,
              on);
    if (on && lr == 0) {
      const T d = static_cast<T>(denom);
      const T rz = a.rz[c];
      s_rz[c] = rz;
      s_alpha[c] = rz / (d > T(0) ? d : T(1));
    }
  }
  __syncthreads();
  for (int c0 = 0; c0 < r; c0 += cols) {
    const int c = c0 + lc;
    const bool on = row_on && c < r;
    double rzs = 0.0, rrs = 0.0;
    if (on) {
      const T alpha = s_alpha[c];
      for (long long k = 0; k < nrow; ++k) {
        const long long i = row0 + k * row_step;
        const long long e = i * r + c;
        const T x = a.X[e] + alpha * a.P[e];
        const T res = a.R[e] - alpha * a.AP[e];
        a.X[e] = x;
        a.R[e] = res;
        const T z = a.minv[i] * res;
        rzs += static_cast<double>(res) * static_cast<double>(z);
        rrs += static_cast<double>(res) * static_cast<double>(res);
      }
    }
    column_sums(rzs, rrs, sa, sb, lr, lc, rows, cols, on);
    if (on && lr == 0) {
      double* p = part1 + static_cast<long long>(blockIdx.x) * 2 * r;
      p[c] = rzs;
      p[r + c] = rrs;
    }
  }
  grid_sync(bar);

  // phase 3: beta, the stopping test and P = Z + beta P
  for (int c0 = 0; c0 < r; c0 += cols) {
    const int c = c0 + lc;
    const bool on = row_on && c < r;
    double rzn, rrn;
    grid_sums(part1, part1 + r, 2 * r, c, rzn, rrn, sa, sb, lr, lc, rows,
              cols, on);
    if (on && lr == 0) {
      const T rz_new = static_cast<T>(rzn);
      const T rz = s_rz[c];
      s_beta[c] = rz_new / (rz > T(0) ? rz : T(1));
      if (blockIdx.x == 0) a.rz[c] = rz_new;
      if (static_cast<T>(rrn) / a.b2[c] > static_cast<T>(a.tol2)) s_above = 1;
    }
  }
  __syncthreads();
  for (int c0 = 0; c0 < r; c0 += cols) {
    const int c = c0 + lc;
    if (!(row_on && c < r)) continue;
    const T beta = s_beta[c];
    for (long long k = nrow - 1; k >= 0; --k) {
      const long long i = row0 + k * row_step;
      const long long e = i * r + c;
      a.P[e] = a.minv[i] * a.R[e] + beta * a.P[e];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const int it = a.state[1] + 1;
    a.state[1] = it;
    a.state[0] = (it >= a.maxiter || !s_above) ? 1 : 0;
  }
}

template <typename T>
size_t shared_bytes(int r) {
  return 2 * kThreads * sizeof(double) + 3 * static_cast<size_t>(r) *
                                             sizeof(T);
}

template <typename T>
int plan(long long n, int r, int* out) {
  if (n <= 0 || r <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the dynamic limit goes to the most the card allows beside the
  // kernel's static shared memory, never to this shape's bytes: an earlier
  // plan's launches of a wider shape must still fit after this one
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, cg_step_kernel<T>);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int limit = optin - static_cast<int>(attr.sharedSizeBytes);
  const size_t smem = shared_bytes<T>(r);
  if (limit <= 0 || smem > static_cast<size_t>(limit))
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(cg_step_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             limit);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cg_step_kernel<T>, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int cols = r < kThreads ? r : kThreads;
  const long long rows = kThreads / cols;
  const long long need = (n + rows - 1) / rows;
  const long long most = static_cast<long long>(per_sm) * sms;
  out[0] = static_cast<int>(need < most ? need : most);
  out[1] = static_cast<int>(smem);
  return 0;
}

template <typename T>
int step(T* X, T* R, T* P, const T* AP, const T* minv, T* rz, const T* b2,
         int* state, double* work, long long n, int r, double tol2,
         int maxiter, int grid, int smem, cudaStream_t stream) {
  if (n <= 0 || r <= 0 || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  StepArgs<T> a{X, R, P, AP, minv, rz, b2, state, work, n, r, tol2, maxiter};
  void* params[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      (const void*)cg_step_kernel<T>, dim3(grid),
      dim3(kThreads), params, static_cast<size_t>(smem), stream));
}

}  // namespace

extern "C" {

// The launch geometry of a step on (n, r) blocks of 4- or 8-byte floats on
// the current device: out[0] the grid (at most the blocks resident at
// once), out[1] the dynamic shared bytes (the kernel's limit raised to the
// most the card allows it, so plans in any order leave every planned
// shape launchable). Returns the cudaError_t (0 on success).
int george_cg_plan(int itemsize, long long n, int r, int* out) {
  if (itemsize == 4) return plan<float>(n, r, out);
  if (itemsize == 8) return plan<double>(n, r, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

// One CG step in place (see the top of this file) on `stream`, with the
// geometry of george_cg_plan and a workspace of 1 + 3 * grid * r doubles
// whose first word was zeroed when it was made. Returns the cudaError_t of
// the launch (0 on success).
int george_cg_step_f32(float* X, float* R, float* P, const float* AP,
                       const float* minv, float* rz, const float* b2,
                       int* state, double* work, long long n, int r,
                       double tol2, int maxiter, int grid, int smem,
                       void* stream) {
  return step<float>(X, R, P, AP, minv, rz, b2, state, work, n, r, tol2,
                     maxiter, grid, smem, static_cast<cudaStream_t>(stream));
}

int george_cg_step_f64(double* X, double* R, double* P, const double* AP,
                       const double* minv, double* rz, const double* b2,
                       int* state, double* work, long long n, int r,
                       double tol2, int maxiter, int grid, int smem,
                       void* stream) {
  return step<double>(X, R, P, AP, minv, rz, b2, state, work, n, r, tol2,
                      maxiter, grid, smem, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
