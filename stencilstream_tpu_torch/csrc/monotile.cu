// Resident-grid kernel: the whole grid lives in the CTAs' shared memory and
// all n iterations of a call run in one cooperative launch.
//
// Replaces the TPU kernel stencilstream_tpu/backends/monotile.py:_run_monotile
// (inner `kernel`, pallas_call at :253), which keeps the whole grid in VMEM
// and loops over every iteration inside one kernel.
//
// Each CTA owns a band of `band` full-width rows and keeps, in shared memory,
// its variant fields (two ping-pong planes) and its invariant fields (staged
// once), each with a deep halo of q*r rows above and below the band and r
// halo columns left and right. Cells outside the grid hold the halo value
// and are never computed. Each sub-step reads its iteration's
// time-dependent value, if the functor takes one, from the call's stream of
// n values (common.cuh: read_tdv).
//
// What bounds it on Hopper: the grid never leaves the chip, so device memory
// is touched once per call (load and store), and the float32 operations set
// the bound (HotSpot 1024^2, n=1000: 0.157 ms). What holds it back (PERF.md,
// NVIDIA H100 at 700 W, HotSpot 1024^2, n=1000, q=4): the sub-steps' runs,
// 2.07 ms with the exchanges removed, about 1.2 us for a run of 8 cells in
// every warp of an SM, as in the tile pass; then the exchanges, about 1 ms
// with the runs removed, 3-4 us each. A band depends only on the bands
// beside it, and every band waits on them exchange after exchange, so the
// slowest band sets the pace of all. The design:
//
// * Neighbour flags in place of a grid-wide barrier. A CTA publishes its top
//   and bottom q*r rows into a global exchange buffer; after a barrier one
//   thread stores the CTA's flag with release semantics at device scope and
//   spins with acquire loads on the flags of CTAs b-1 and b+1 only; a
//   barrier later the CTA pulls their rows into its deep halo. (The
//   barrier orders the CTA's stores before the release, as in CUTLASS's
//   semaphore; a __threadfence before it measured slower.) Flags count
//   exchanges on from an epoch that the wrapper advances per launch, so
//   flags left by an earlier launch never satisfy a wait and need no reset.
// * Several sub-steps per exchange. Between two exchanges a CTA runs q
//   sub-steps (q*r <= band, so it only ever reads from b-1 and b+1) on a
//   window that narrows by r a side per sub-step: sub-step j of a group of g
//   computes the band plus (g-j)*r rows a side, 1 + r(q-1)/band cells per
//   useful cell (in whole runs: 1.75 lane-cells at q=4 on 8-row bands),
//   while exchanges fall q-fold. The last group of a call is shorter when
//   n*k is not a multiple of q.
// * The exchange buffer is double-buffered by exchange parity. A CTA cannot
//   publish exchange e+2 before both of its neighbours have finished reading
//   exchange e: it publishes e+2 only after it has pulled exchange e+1 from
//   them, and each of them published e+1 only after it had pulled e. So two
//   buffers are enough. A side of a band is q*r whole plane rows per field
//   (halo columns included), so publish and pull are flat copies.
// * The division-free run body of the line cache (common.cuh: run_cells): a
//   warp covers 32 columns, each thread a run of run_rows<Op>() cells down
//   its column; 32-column chunks and runs are dealt to warps with counters,
//   and the last chunk and run are shifted back inside the window. Every
//   cell of a run lies in the grid, and warp-uniform tests per run pick the
//   body: edge-free where the run's rows and columns keep r from the grid's
//   edges (every band but the first and the last, the columns >= r from
//   either side), and otherwise one that keeps the functor's edge tests
//   only in the direction that needs them. The first and last bands thus run
//   nearly as fast as the others; with the line cache's edge body, which
//   tests every cell against the grid, they held every band back (PERF.md).
//
// Narrow storage (common.cuh: Narrow): the functor's T is the storage type,
// so the band's planes and the exchange rows hold bfloat16 or float8 cells;
// the exchange moves their bits through L2.
//
// Every CTA must be resident at once, since a CTA spins on its neighbours:
// the launcher launches cooperatively, which guarantees that or refuses the
// launch.
#include <cuda_runtime.h>

#include "common.cuh"
#include "ops/all.cuh"

namespace ss {

constexpr int kMonoMaxThreads = 1024;
constexpr int kFlagStride = 32;  // unsigned per CTA flag: one 128-byte line each

template <class Op>
struct MonotileArgs {
  using T = typename Op::T;
  Fields<Op> f;
  T* xchg;          // [exchange parity 2][cta][side 2][variant field][q*r rows x pitch]
  unsigned* flags;  // [cta * kFlagStride]: epoch + the last exchange the CTA published
  unsigned epoch;   // every flag is at most this when the launch starts
  int H, W;         // logical grid extent
  int band;         // rows per CTA
  int q;            // sub-steps per exchange
  int offset;       // absolute iteration of the first step
  int n_iterations;
  const void* tdv;  // the call's TDV stream: element i - offset for iteration i
};

__device__ __forceinline__ void release_flag(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned acquire_flag(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Spin until the flag reaches `target` (wrap-around safe).
__device__ __forceinline__ void wait_flag(const unsigned* p, unsigned target) {
  while (static_cast<int>(acquire_flag(p) - target) < 0) {
  }
}

// A load and a store through L2 only; the narrow storage types by their
// bits.
template <class T>
__device__ __forceinline__ T load_cg(const T* p) {
  if constexpr (is_narrow<T>())
    return T{__ldcg(&p->bits)};
  else
    return __ldcg(p);
}

template <class T>
__device__ __forceinline__ void store_cg(T* p, const T& v) {
  if constexpr (is_narrow<T>())
    __stcg(&p->bits, v.bits);
  else
    __stcg(p, v);
}

// A flat copy of n elements from the global exchange buffer into shared
// memory by the whole CTA, eight loads in flight a thread; through L2 only.
template <class T>
__device__ __forceinline__ void pull_span(T* dst, const T* src, int n, int tid, int nt) {
  constexpr int U = 8;
  for (int e0 = tid; e0 < n; e0 += U * nt) {
    T v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (e0 + u * nt < n) v[u] = load_cg(src + e0 + u * nt);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (e0 + u * nt < n) dst[e0 + u * nt] = v[u];
  }
}

// A flat copy of n elements from shared memory into the global exchange
// buffer, stored in L2.
template <class T>
__device__ __forceinline__ void publish_span(T* dst, const T* src, int n, int tid, int nt) {
  for (int e = tid; e < n; e += nt) store_cg(dst + e, src[e]);
}

template <class Op>
__global__ void __launch_bounds__(kMonoMaxThreads, 1)
monotile_kernel(const MonotileArgs<Op> a, const Op op) {
  using T = typename Op::T;
  constexpr int NV = Op::kVariant;
  constexpr int NI = Op::kInvariant;
  constexpr int R = Op::kRadius;
  constexpr int K = Op::kSubiterations;
  constexpr int V = run_rows<Op>();
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int nw = blockDim.y;
  const int nt = nw * 32;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int b = blockIdx.x;
  const int nb = gridDim.x;
  const int qr = a.q * R;
  const int pitch = a.W + 2 * R;
  const int rows = a.band + 2 * qr;
  const int plane = rows * pitch;
  const int top = b * a.band - qr;  // global row of plane row 0
  T* var = reinterpret_cast<T*>(smem_raw);  // [variant field][ping-pong 2][plane]
  T* inv = var + 2 * NV * plane;            // [invariant field][plane]

  // Load the band with its deep halo into both ping-pong planes; cells
  // outside the grid get the halo value.
  for (int pr = threadIdx.y; pr < rows; pr += nw) {
    const int gr = top + pr;
    const bool row_in = gr >= 0 && gr < a.H;
    const long g = static_cast<long>(gr) * a.W - R;  // global index of plane column 0
    T* s = var + pr * pitch;
    for (int c = threadIdx.x; c < pitch; c += 32) {
      const bool in = row_in && c >= R && c < a.W + R;
#pragma unroll
      for (int f = 0; f < NV; ++f) {
        const T v = in ? a.f.var_in[f][g + c] : a.f.halo_var[f];
        s[f * 2 * plane + c] = v;
        s[f * 2 * plane + plane + c] = v;
      }
#pragma unroll
      for (int f = 0; f < NI; ++f)
        inv[f * plane + pr * pitch + c] = in ? a.f.inv[f][g + c] : a.f.halo_inv[f];
    }
  }
  __syncthreads();

  const int side = NV * qr * pitch;  // elements of one side of one CTA
  const int span = qr * pitch;       // one field's rows of one side
  const long parity = 2L * nb * side;
  const bool up = b > 0, down = b < nb - 1;
  const int lo_grid = -top;        // plane row of global row 0
  const int hi_grid = a.H - top;   // plane row of global row H
  const int n_chunks = (a.W + 31) >> 5;
  const int steps = a.n_iterations * K;
  int iteration = a.offset, sub = 0, cur = 0;
  unsigned e = 0;
  for (int s0 = 0; s0 < steps; s0 += a.q) {
    const int group = min(a.q, steps - s0);
    if (s0 > 0) {
      // Exchange e: publish this band's top and bottom q*r rows, raise this
      // CTA's flag, wait on the flags of CTAs b-1 and b+1 only, and pull
      // their rows into the deep halo. One thread stores and spins, between
      // two barriers: a release store makes the CTA's writes that the
      // barrier ordered before it visible with the flag, an acquire load
      // the neighbour's.
      ++e;
      T* cp = var + cur * plane;
      T* x = a.xchg + (e & 1) * parity;
      T* mine = x + 2L * b * side;
#pragma unroll
      for (int f = 0; f < NV; ++f) {
        if (up) publish_span(mine + f * span, cp + f * 2 * plane + qr * pitch, span, tid, nt);
        if (down)
          publish_span(mine + side + f * span, cp + f * 2 * plane + a.band * pitch, span, tid, nt);
      }
      __syncthreads();
      if (tid == 0) {
        release_flag(a.flags + b * kFlagStride, a.epoch + e);
        if (up) wait_flag(a.flags + (b - 1) * kFlagStride, a.epoch + e);
        if (down) wait_flag(a.flags + (b + 1) * kFlagStride, a.epoch + e);
      }
      __syncthreads();
#pragma unroll
      for (int f = 0; f < NV; ++f) {
        // Plane rows 0..qr-1: the bottom side of CTA b-1; plane rows
        // band+qr..: the top side of CTA b+1.
        if (up) pull_span(cp + f * 2 * plane, x + 2L * (b - 1) * side + side + f * span, span, tid, nt);
        if (down)
          pull_span(cp + f * 2 * plane + (qr + a.band) * pitch, x + 2L * (b + 1) * side + f * span,
                    span, tid, nt);
      }
      __syncthreads();
    }
    // The group's sub-steps: the band plus m rows a side, m = (group-1)*r
    // down to 0, within the grid. A group never runs past the call's last
    // sub-step, so no step reads the TDV stream past offset + n.
    for (int m = (group - 1) * R; m >= 0; m -= R) {
      const tdv_t<Op> tdv = read_tdv<Op>(a.tdv, iteration - a.offset);
      const int lo = max(qr - m, lo_grid);
      const int hi = min(qr + a.band + m, hi_grid);
      const int n_rows = hi - lo;
      const int n_runs = (n_rows + V - 1) / V;
      const T* src = var + cur * plane;
      T* dst = var + (cur ^ 1) * plane;
      int jx = threadIdx.y, jy = 0;
      while (jx >= n_chunks) jx -= n_chunks, ++jy;
      while (jy < n_runs) {
        // A run that would cross the window's last row is shifted back
        // inside it (it recomputes rows the run above also writes, with the
        // same values); a window shorter than a run takes one short run.
        const bool full = n_rows >= V;
        const int pr = full ? min(lo + jy * V, hi - V) : lo;
        const int c0 = a.W >= 32 ? min(jx << 5, a.W - 32) : 0;
        const int c = c0 + threadIdx.x;
        const int gr = top + pr;
        const long li = static_cast<long>(pr) * pitch + c + R;
        const T* s = src + li;
        T* d = dst + li;
        const T* i = inv + li;
        // Warp-uniform: whether the run's cells and their neighbours lie in
        // the grid, by rows and by columns. Every cell of a run lies in the
        // grid (lanes past its last column idle), so no run tests its cells
        // one by one.
        const bool rows_in = gr >= R && gr + V <= a.H - R;
        const bool cols_in = c0 >= R && c0 + 32 <= a.W - R;
        if (full && rows_in && cols_in) {
          run_cells<Op, true, true, false>(op, a.f, s, d, i, 2L * plane, plane, pitch, gr, c, a.H,
                                           a.W, iteration, sub, tdv);
        } else if (c < a.W) {
          if (!full)
            run_cells<Op, false, false, false>(op, a.f, s, d, i, 2L * plane, plane, pitch, gr, c,
                                               a.H, a.W, iteration, sub, tdv, n_rows);
          else if (rows_in)
            run_cells<Op, true, false, false>(op, a.f, s, d, i, 2L * plane, plane, pitch, gr, c,
                                              a.H, a.W, iteration, sub, tdv);
          else if (cols_in)
            run_cells<Op, false, true, false>(op, a.f, s, d, i, 2L * plane, plane, pitch, gr, c,
                                              a.H, a.W, iteration, sub, tdv);
          else
            run_cells<Op, false, false, false>(op, a.f, s, d, i, 2L * plane, plane, pitch, gr, c,
                                               a.H, a.W, iteration, sub, tdv);
        }
        jx += nw;
        while (jx >= n_chunks) jx -= n_chunks, ++jy;
      }
      __syncthreads();
      cur ^= 1;
      if (++sub == K) sub = 0, ++iteration;
    }
  }

  // Store the band's rows that lie in the grid.
  const T* res = var + cur * plane;
  const int grows = min(a.band, a.H - b * a.band);
  for (int i = threadIdx.y; i < grows; i += nw) {
    const T* s = res + (qr + i) * pitch + R;
    const long g = static_cast<long>(b * a.band + i) * a.W;
    for (int c = threadIdx.x; c < a.W; c += 32) {
#pragma unroll
      for (int f = 0; f < NV; ++f) a.f.var_out[f][g + c] = s[f * 2 * plane + c];
    }
  }
}

template <class Op>
size_t monotile_smem_bytes(int band, int q, int W) {
  return cell_smem_bytes<Op>() * static_cast<size_t>(band + 2 * q * Op::kRadius) *
         static_cast<size_t>(W + 2 * Op::kRadius);
}

// Raise the kernel's dynamic shared memory limit to `smem` on the current
// device, once per device and size (the attribute only ever grows).
template <class Op>
cudaError_t allow_smem(size_t smem) {
  constexpr int kDevices = 64;
  static size_t allowed[kDevices] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < kDevices && allowed[device] >= smem) return cudaSuccess;
  e = cudaFuncSetAttribute(monotile_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e == cudaSuccess && device < kDevices) allowed[device] = smem;
  return e;
}

template <class Op>
int launch_monotile(void* const* var_in, void* const* var_out, void* const* inv, int H, int W,
                    int band, int n_ctas, int q, int threads, int offset, int n_iterations,
                    const double* params, const double* halo, const void* tdv, void* xchg,
                    void* flags, unsigned epoch, void* stream) {
  if (q < 1 || q * Op::kRadius > band || threads < 32 || threads > kMonoMaxThreads ||
      threads % 32 != 0 || n_ctas != (H + band - 1) / band || n_iterations < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  MonotileArgs<Op> a;
  a.f = make_fields<Op>(var_in, var_out, inv, halo);
  a.xchg = static_cast<typename Op::T*>(xchg);
  a.flags = static_cast<unsigned*>(flags);
  a.epoch = epoch;
  a.H = H;
  a.W = W;
  a.band = band;
  a.q = q;
  a.offset = offset;
  a.n_iterations = n_iterations;
  a.tdv = tdv;
  Op op = Op::from_params(params);
  const size_t smem = monotile_smem_bytes<Op>(band, q, W);
  cudaError_t e = allow_smem<Op>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // A grid whose CTAs cannot all be resident is refused here
  // (cudaErrorCooperativeLaunchTooLarge).
  void* args[] = {&a, &op};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(monotile_kernel<Op>),
                                  dim3(n_ctas), dim3(32, threads / 32), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of monotile_kernel<Op> that one SM of the current device holds at
// this geometry, as the runtime counts.
template <class Op>
int monotile_residency(int band, int q, int W, int threads, int* blocks_per_sm) {
  const size_t smem = monotile_smem_bytes<Op>(band, q, W);
  cudaError_t e = allow_smem<Op>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, monotile_kernel<Op>, threads, smem));
}

}  // namespace ss

#define SS_MONOTILE_ENTRY(name, ...)                                                                      \
  extern "C" int ss_monotile_##name(void* const* var_in, void* const* var_out,                            \
                                    void* const* inv, int H, int W, int band, int n_ctas, int q,          \
                                    int threads, int offset, int n_iterations,                            \
                                    const double* params, const double* halo, const void* tdv,            \
                                    void* xchg, void* flags, unsigned epoch, void* stream) {              \
    return ss::launch_monotile<__VA_ARGS__>(var_in, var_out, inv, H, W, band, n_ctas, q, threads, offset, \
                                   n_iterations, params, halo, tdv, xchg, flags, epoch, stream);          \
  }                                                                                                       \
  extern "C" int ss_monotile_residency_##name(int band, int q, int W, int threads,                        \
                                              int* blocks_per_sm) {                                       \
    return ss::monotile_residency<__VA_ARGS__>(band, q, W, threads, blocks_per_sm);                       \
  }

SS_FOR_EACH_OP(SS_MONOTILE_ENTRY)
SS_FOR_EACH_NARROW_OP(SS_MONOTILE_ENTRY)
