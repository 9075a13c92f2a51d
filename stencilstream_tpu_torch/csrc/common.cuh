// Shared pieces of the stencil kernels: the neighbourhood view a device
// functor reads, the field pointers and halo values a launch carries, the
// host-side argument unpacking of the plain C interface, the run length of
// the thread maps, the run body of the line-cache and resident-grid kernels,
// and the asynchronous staging of window rows into shared memory.
//
// A device functor ("Op", see ops/hotspot.cuh) is the C++ twin of a Python
// transition function. It declares
//   using T                   the element type of every cell field, in which
//                             the kernels store, stage and exchange cells,
//   kRadius, kSubiterations   the stencil radius r and sub-steps k,
//   kVariant, kInvariant      how many cell fields it updates and how many
//                             it only reads (loop-invariant fields),
//   kParams                   how many scalar runtime parameters it takes,
//   from_params(const double*) building the functor from those scalars,
//   operator()(const Taps&, T* out) writing the new variant fields, a
//                             template over the Taps type (Taps<T, tdv_t<Op>>
//                             in the kernels, a narrow-storage view in
//                             Narrow below),
// and, if its transition function has a time-dependent value (TDV),
//   using Tdv                 the TDV's type (float for FDTD's source
//                             amplitude, int for the probe's iteration),
// and, if each sub-step changes only some variant fields and reads those
// only at the cell itself, or at cells the sub-step leaves bit-unchanged
// (FDTD's leapfrog; convection's pseudo-transient update: ops/convection.cuh),
//   kWrites[kSubiterations]   sub-step s's changed fields, bit f for field f
//                             (the tile pass then updates them in place).
// Its runtime parameters travel by value as a kernel argument on every
// launch, so changing them never rebuilds anything. No kernel evaluates a
// TDV: each launch gets a pointer to the call's stream of n values, which
// the TDV strategy (tdv.py) evaluated once per call on the grid's device,
// and a step of absolute iteration i reads element i - offset (read_tdv);
// no step at or past offset + n reads it.
//
// Narrow storage (Narrow<Op, S>, the counterpart of the JAX package's
// backends/storage_cast.py:CastStorageKernel): a functor whose compute type
// is float, run on cells stored as bfloat16 or float8 e4m3. The wrapper is a
// functor whose T is the storage type S, so every plane in device memory,
// in shared memory and in the resident grid's exchange rows holds S, and
// every byte count follows sizeof(S); each tap is converted S -> float when
// it is read (exactly), and each sub-step's output is rounded float -> S
// when it is stored, as the JAX package's canonicalize_cell rounds it:
// bfloat16 to nearest even, float8 e4m3 to nearest even with NaN for
// anything beyond its range (|x| > 464), never saturated.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
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

// Narrow storage types: the bits of one bfloat16 or float8 e4m3 (fn: no
// infinities, one NaN pattern per sign) value.
struct Bf16 {
  unsigned short bits;
};
struct E4m3 {
  unsigned char bits;
};

template <class S>
__host__ __device__ constexpr bool is_narrow() {
  return std::is_same<S, Bf16>::value || std::is_same<S, E4m3>::value;
}

// A stored value in the compute type: exact for the narrow types.
template <class T, class S>
__device__ __forceinline__ T to_compute(const S& x) {
  if constexpr (std::is_same<T, S>::value) {
    return x;
  } else if constexpr (std::is_same<S, Bf16>::value) {
    return __bfloat162float(__ushort_as_bfloat16(x.bits));
  } else if constexpr (std::is_same<S, E4m3>::value) {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(x.bits, __NV_E4M3)));
  } else {
    return static_cast<T>(x);
  }
}

// A computed value rounded to the storage type: bfloat16 to nearest even;
// float8 e4m3 to nearest even and NaN beyond its range (no saturation).
template <class S, class T>
__host__ __device__ __forceinline__ S to_storage(T x) {
  if constexpr (std::is_same<S, Bf16>::value) {
    return Bf16{__bfloat16_as_ushort(__float2bfloat16_rn(static_cast<float>(x)))};
  } else if constexpr (std::is_same<S, E4m3>::value) {
    return E4m3{__nv_cvt_float_to_fp8(static_cast<float>(x), __NV_NOSAT, __NV_E4M3)};
  } else {
    return static_cast<S>(x);
  }
}

// A launch's double (a halo value) in the storage type; narrow types round
// through float, as the JAX package casts its float32 halo cell.
template <class S>
__host__ __forceinline__ S from_double(double x) {
  if constexpr (is_narrow<S>())
    return to_storage<S>(static_cast<float>(x));
  else
    return static_cast<S>(x);
}

// Neighbourhood of one cell. Variant fields come from the current ping-pong
// plane, invariant fields from their staged plane; all planes share one row
// pitch and carry the halo value outside the grid. The planes hold S; taps
// are read as T.
template <class T, class D = NoTdv, class S = T>
struct Taps {
  using Storage = S;
  const S* var;       // variant field 0 at the central cell
  const S* inv;       // invariant field 0 at the central cell
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
    return to_compute<T>(var[f * var_stride + dr * pitch + dc]);
  }
  // Invariant field f at signed offset (dr, dc).
  __device__ __forceinline__ T i(int f, int dr, int dc) const {
    return to_compute<T>(inv[f * inv_stride + dr * pitch + dc]);
  }
};

// A functor Op (compute type float) on cells stored as S (Bf16 or E4m3):
// its T is S, so the kernels store, stage and exchange S; it hands Op a
// view whose taps read as float and rounds Op's outputs to S.
template <class Op, class S>
struct Narrow {
  static_assert(std::is_same<typename Op::T, float>::value, "narrow storage computes in float");
  using T = S;
  using Tdv = tdv_t<Op>;
  static constexpr int kRadius = Op::kRadius;
  static constexpr int kSubiterations = Op::kSubiterations;
  static constexpr int kVariant = Op::kVariant;
  static constexpr int kInvariant = Op::kInvariant;
  static constexpr int kParams = Op::kParams;

  Op op;

  static Narrow from_params(const double* p) { return Narrow{Op::from_params(p)}; }

  template <class Tp>
  __device__ __forceinline__ void operator()(const Tp& s, S* out) const {
    const Taps<float, Tdv, S> t{s.var, s.inv, s.var_stride, s.inv_stride, s.pitch, s.row,
                                s.col, s.H,   s.W,          s.iteration,  s.subiteration,
                                s.tdv};
    float r[kVariant];
    op(t, r);
#pragma unroll
    for (int f = 0; f < kVariant; ++f) out[f] = to_storage<S>(r[f]);
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
// first, then invariant fields), the halo values rounded to T.
template <class Op>
Fields<Op> make_fields(void* const* var_in, void* const* var_out, void* const* inv,
                       const double* halo) {
  using T = typename Op::T;
  Fields<Op> f{};
  for (int j = 0; j < Op::kVariant; ++j) {
    f.var_in[j] = static_cast<const T*>(var_in[j]);
    f.var_out[j] = static_cast<T*>(var_out[j]);
    f.halo_var[j] = from_double<T>(halo[j]);
  }
  for (int j = 0; j < Op::kInvariant; ++j) {
    f.inv[j] = static_cast<const T*>(inv[j]);
    f.halo_inv[j] = from_double<T>(halo[Op::kVariant + j]);
  }
  return f;
}

// The rows and columns a sub-step reads below (lo) and above (hi) a cell, on
// both axes: what a functor declares as Op::kReach[s] where its sub-steps
// read one-sided (the tile pass: tile_pass.cu, reach).
struct Reach {
  int lo, hi;
};

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

// Stage WH rows of one field's window into shared memory at `win`: window
// cell (wr, c) is element (row0 + wr, col0 + c) of a block whose rows lie
// `gpitch` elements apart from `g` (row0 and col0 may be negative). Rows are
// dealt to the kWarps warps of the CTA (threadIdx.y). Elements in block rows
// [r_lo, r_hi) and columns [c_lo, c_hi), the part of the block that is
// stored and inside the grid, are copied; every other window cell gets the
// halo value. The copied span of a row goes by cp.async, 16 bytes at a time
// between its first and last 16-byte boundary when `vec16` (the row's
// shared and global addresses then agree modulo 16 bytes), cell by cell
// elsewhere. 1-byte cells are copied one per lane with plain loads and
// stores, which measured faster for them; 2-byte cells (bfloat16), which
// have no cp.async of their own size, take plain loads outside the 16-byte
// body. The caller commits the group, waits for it and synchronises the CTA.
template <int kWarps, class T>
__device__ __forceinline__ void stage_block(T* win, int pitch, const T* g, int gpitch, T halo,
                                            int row0, int col0, int WH, int WW, int r_lo,
                                            int r_hi, int c_lo, int c_hi, bool vec16) {
  constexpr int E = 16 / sizeof(T);
  const int lane = threadIdx.x;
  // What every row shares, once: the copied columns [a, b), their 16-byte
  // body [lo, hi) and the copied window rows [w_lo, w_hi).
  const int a = max(col0, c_lo) - col0;       // first copied window column
  const int b = min(col0 + WW, c_hi) - col0;  // end of the copied columns
  const int w_lo = max(r_lo - row0, 0);
  const int w_hi = b <= a ? 0 : min(r_hi - row0, WH);
  int lo = b, hi = b;
  if (sizeof(T) > 1 && vec16) {
    lo = min(b, a + ((E - ((col0 + a) & (E - 1))) & (E - 1)));
    hi = lo + ((b - lo) & ~(E - 1));
  }
  for (int wr = threadIdx.y; wr < WH; wr += kWarps) {
    T* s = win + wr * pitch;
    if (wr < w_lo || wr >= w_hi) {
      for (int c = lane; c < WW; c += 32) s[c] = halo;
      continue;
    }
    for (int c = lane; c < a; c += 32) s[c] = halo;
    for (int c = b + lane; c < WW; c += 32) s[c] = halo;
    const T* gp = g + (static_cast<long>(row0 + wr) * gpitch + col0);
    if constexpr (sizeof(T) > 1)
      for (int c = lo + lane * E; c < hi; c += 32 * E) cp_async<16>(s + c, gp + c);
    for (int c = a + lane; c < lo; c += 32) copy_cell(s + c, gp + c);
    for (int c = hi + lane; c < b; c += 32) copy_cell(s + c, gp + c);
  }
}

// stage_block out of line: the compiler then allocates the staging's
// registers apart from its caller's.
template <int kWarps, class T>
__device__ __noinline__ void stage_block_outlined(T* win, int pitch, const T* g, int gpitch, T halo,
                                                  int row0, int col0, int WH, int WW, int r_lo,
                                                  int r_hi, int c_lo, int c_hi, bool vec16) {
  stage_block<kWarps>(win, pitch, g, gpitch, halo, row0, col0, WH, WW, r_lo, r_hi, c_lo, c_hi, vec16);
}

// stage_block over a whole H x W grid (global rows row0.., columns col0..):
// out-of-grid cells get the halo value.
template <int kWarps, class T>
__device__ __forceinline__ void stage_field(T* win, int pitch, const T* g, T halo, int row0,
                                            int col0, int WH, int WW, int H, int W, bool vec16) {
  stage_block<kWarps>(win, pitch, g, W, halo, row0, col0, WH, WW, 0, H, 0, W, vec16);
}

}  // namespace ss
