// Shared pieces of the stencil kernels: the neighbourhood view a device
// functor reads, the field pointers and halo values a launch carries, the
// host-side argument unpacking of the plain C interface, the run length of
// the thread maps, the run body of the line-cache and resident-grid kernels,
// and the asynchronous staging of window rows into shared memory.
//
// A device functor ("Op", see ops/hotspot.cuh) is the C++ twin of a Python
// transition function. It declares
//   using T                   the element type of every cell field,
//   kRadius, kSubiterations   the stencil radius r and sub-steps k,
//   kVariant, kInvariant      how many cell fields it updates and how many
//                             it only reads (loop-invariant fields),
//   kParams                   how many scalar runtime parameters it takes,
//   from_params(const double*) building the functor from those scalars,
//   operator()(const Taps<T, tdv_t<Op>>&, T* out) writing the new variant
//                             fields,
// and, if its transition function has a time-dependent value (TDV),
//   using Tdv                 the TDV's type (float for FDTD's source
//                             amplitude, int for the probe's iteration).
// Its runtime parameters travel by value as a kernel argument on every
// launch, so changing them never rebuilds anything. No kernel evaluates a
// TDV: each launch gets a pointer to the call's stream of n values, which
// the TDV strategy (tdv.py) evaluated once per call on the grid's device,
// and a step of absolute iteration i reads element i - offset (read_tdv);
// no step at or past offset + n reads it.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace ss {

// The TDV type of a functor that declares none.
struct NoTdv {};

template <class Op, class = void>
struct TdvOf {
  using type = NoTdv;
};
template <class Op>
struct TdvOf<Op, std::void_t<typename Op::Tdv>> {
  using type = typename Op::Tdv;
};
template <class Op>
using tdv_t = typename TdvOf<Op>::type;

// The value of a step's TDV: element i of the call's stream (i = the step's
// iteration less the call's offset); nothing for a functor without one.
template <class Op>
__device__ __forceinline__ tdv_t<Op> read_tdv(const void* stream, int i) {
  using D = tdv_t<Op>;
  if constexpr (std::is_same<D, NoTdv>::value) {
    return {};
  } else {
    return __ldg(static_cast<const D*>(stream) + i);
  }
}

// Neighbourhood of one cell. Variant fields come from the current ping-pong
// plane, invariant fields from their staged plane; all planes share one row
// pitch and carry the halo value outside the grid.
template <class T, class D = NoTdv>
struct Taps {
  const T* var;       // variant field 0 at the central cell
  const T* inv;       // invariant field 0 at the central cell
  long var_stride;    // elements between two variant fields' planes
  long inv_stride;    // elements between two invariant fields' planes
  int pitch;          // row pitch of every plane
  int row, col;       // global coordinates of the central cell
  int H, W;           // logical grid extent
  int iteration;      // absolute iteration index
  int subiteration;
  D tdv;              // the iteration's time-dependent value

  // Variant field f at signed offset (dr, dc).
  __device__ __forceinline__ T v(int f, int dr, int dc) const {
    return var[f * var_stride + dr * pitch + dc];
  }
  // Invariant field f at signed offset (dr, dc).
  __device__ __forceinline__ T i(int f, int dr, int dc) const {
    return inv[f * inv_stride + dr * pitch + dc];
  }
};

constexpr int at_least_one(int n) { return n > 0 ? n : 1; }

// Field pointers and halo values of one launch, in the functor's order.
template <class Op>
struct Fields {
  using T = typename Op::T;
  const T* var_in[Op::kVariant];
  T* var_out[Op::kVariant];
  const T* inv[at_least_one(Op::kInvariant)];
  T halo_var[Op::kVariant];
  T halo_inv[at_least_one(Op::kInvariant)];
};

// Unpack the C interface's pointer arrays and halo doubles (variant fields
// first, then invariant fields).
template <class Op>
Fields<Op> make_fields(void* const* var_in, void* const* var_out, void* const* inv,
                       const double* halo) {
  using T = typename Op::T;
  Fields<Op> f{};
  for (int j = 0; j < Op::kVariant; ++j) {
    f.var_in[j] = static_cast<const T*>(var_in[j]);
    f.var_out[j] = static_cast<T*>(var_out[j]);
    f.halo_var[j] = static_cast<T>(halo[j]);
  }
  for (int j = 0; j < Op::kInvariant; ++j) {
    f.inv[j] = static_cast<const T*>(inv[j]);
    f.halo_inv[j] = static_cast<T>(halo[Op::kVariant + j]);
  }
  return f;
}

// Bytes of one window cell in shared memory: two ping-pong planes per
// variant field, one staged plane per invariant field.
template <class Op>
constexpr size_t cell_smem_bytes() {
  return sizeof(typename Op::T) * (2 * Op::kVariant + Op::kInvariant);
}

constexpr int kRun = 8;          // cells per thread run (one-field functors)
constexpr int kPitchAlign = 16;  // elements a shared row pitch is rounded up to

// Cells a thread computes down one column per sub-step. Multi-field cells
// (the probe's five) keep one, to stay within 64 registers a thread without
// spilling.
template <class Op>
__host__ __device__ constexpr int run_rows() {
  return Op::kVariant == 1 ? kRun : 1;
}

// One thread's run of cells down one column of a sub-step, computed, then
// stored: all of a run's outputs are computed before any is stored, so the
// compiler loads each shared tap that the run's cells share once. src, dst
// and inv point at the run's first cell in its variant planes (fields
// `vstride` elements apart, in src and dst alike) and its invariant planes
// (`istride` apart), rows `pitch` apart; (gr, gc) are that cell's global
// coordinates; only the first n cells are computed and stored (all V unless
// the caller passes fewer). kRows / kCols: every cell of the run has all
// its neighbours inside the grid in that direction, which lets the compiler
// fold the functor's own edge tests there. kOutside: cells may lie outside
// the grid (they get the halo value); otherwise they all lie inside it. The
// line-cache and resident-grid kernels share it.
template <class Op, bool kRows, bool kCols, bool kOutside, int V = run_rows<Op>()>
__device__ __forceinline__ void run_cells(const Op& op, const Fields<Op>& fields,
                                          const typename Op::T* src, typename Op::T* dst,
                                          const typename Op::T* inv, long vstride, long istride,
                                          int pitch, int gr, int gc, int H, int W, int iteration,
                                          int sub, tdv_t<Op> tdv, int n = V) {
  using T = typename Op::T;
  constexpr int NV = Op::kVariant;
  constexpr int R = Op::kRadius;
  const bool col_in = gc >= 0 && gc < W;
  T out[V][NV];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (k >= n) continue;
    if (kOutside && (!col_in || gr + k < 0 || gr + k >= H)) {
#pragma unroll
      for (int f = 0; f < NV; ++f) out[k][f] = fields.halo_var[f];
    } else {
      if (kRows) __builtin_assume(gr + k >= R && gr + k < H - R);
      if (kCols) __builtin_assume(gc >= R && gc < W - R);
      const Taps<T, tdv_t<Op>> t{src + k * pitch, inv + k * pitch, vstride, istride, pitch,
                                 gr + k,          gc,             H,       W,       iteration,
                                 sub,             tdv};
      op(t, out[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (k >= n) continue;
#pragma unroll
    for (int f = 0; f < NV; ++f) dst[f * vstride + k * pitch] = out[k][f];
  }
}

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(shared_address(dst)), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(shared_address(dst)), "l"(src),
                 "n"(N));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

template <class T>
__device__ __forceinline__ void copy_cell(T* dst, const T* src) {
  if constexpr (sizeof(T) == 4 || sizeof(T) == 8)
    cp_async<sizeof(T)>(dst, src);
  else
    *dst = *src;
}

// Stage WH rows of one field's window (global rows row0.., columns col0..)
// into shared memory at `win`, rows dealt to the kWarps warps of the CTA
// (threadIdx.y): out-of-grid cells get the halo value, the in-grid span of a
// row is copied with cp.async, 16 bytes at a time between its first and last
// 16-byte boundary when `vec16` (the row's shared and global addresses then
// agree modulo 16 bytes), cell by cell elsewhere. 1-byte cells are copied
// one per lane with plain loads and stores, which measured faster for them.
// The caller commits the group, waits for it and synchronises the CTA.
template <int kWarps, class T>
__device__ __forceinline__ void stage_field(T* win, int pitch, const T* g, T halo, int row0,
                                            int col0, int WH, int WW, int H, int W, bool vec16) {
  constexpr int E = 16 / sizeof(T);
  const int lane = threadIdx.x;
  const int a = max(col0, 0) - col0;       // first in-grid window column
  const int b = min(col0 + WW, W) - col0;  // end of the in-grid columns
  for (int wr = threadIdx.y; wr < WH; wr += kWarps) {
    T* s = win + wr * pitch;
    const int gr = row0 + wr;
    if (gr < 0 || gr >= H || b <= a) {
      for (int c = lane; c < WW; c += 32) s[c] = halo;
      continue;
    }
    for (int c = lane; c < a; c += 32) s[c] = halo;
    for (int c = b + lane; c < WW; c += 32) s[c] = halo;
    const T* gp = g + static_cast<long>(gr) * W + col0;
    int lo = b, hi = b;  // the 16-byte body [lo, hi)
    if (sizeof(T) > 1 && vec16) {
      lo = min(b, a + ((E - ((col0 + a) & (E - 1))) & (E - 1)));
      hi = lo + ((b - lo) & ~(E - 1));
      for (int c = lo + lane * E; c < hi; c += 32 * E) cp_async<16>(s + c, gp + c);
    }
    for (int c = a + lane; c < lo; c += 32) copy_cell(s + c, gp + c);
    for (int c = hi + lane; c < b; c += 32) copy_cell(s + c, gp + c);
  }
}

}  // namespace ss
