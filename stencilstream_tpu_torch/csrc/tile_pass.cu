// Tile-pass kernel: p fused iterations (p*k sub-steps) of a device functor
// over 2D tiles, one launch per pass.
//
// Replaces the TPU kernel stencilstream_tpu/backends/strip_pass.py:StripPass
// (kernel body built in __init__, pallas_call in StripPass.run), which fuses
// p iterations over full-width row strips held in VMEM.
//
// Each tile's window, the core plus the compound halo hp = r*p*k per side,
// is staged into shared memory once per pass; the p*k sub-steps ping-pong
// between two shared planes per variant field, sub-step s computing only the
// window narrowed by r*(s+1) per side (the cells the next one needs); the
// core is written back. A partial pass stops at the call's last iteration.
// Each step reads its iteration's time-dependent value, if the functor takes
// one, from the call's stream (common.cuh: read_tdv); the steps of a partial
// pass past the call's last iteration read nothing.
//
// What bounds it on Hopper (PERF.md, measured by tile_sweep.py): not device
// memory. At HotSpot 8192^2, p=8, the law's 56x112 core stages a window
// 1.47x the core, ~15.8 B a cell, which alone takes about a third of the
// pass; the rest is shared-memory bandwidth and instruction throughput in the
// sub-steps, which compute whole 32-column chunks and kRun-row runs of the
// narrowing window (1.35 lane-cells per useful cell-step at that geometry)
// with ~4.4 shared loads and ~20 instructions a cell in the interior run
// loop. What the design does about it:
//
// * A 2D thread map without division. A warp covers 32 consecutive columns
//   of one row (conflict-free shared accesses); each thread computes a run of
//   kRun cells down one column. Runs and 32-column chunks are dealt to the
//   warps round-robin with counters, so no index is divided by a runtime
//   value. A chunk or run that would cross the narrowing window's edge is
//   shifted back inside it (it recomputes a few cells the neighbouring one
//   also writes, with the same value), so no lane tests a bound per cell.
// * Register blocking. A thread computes its run's kRun cells before it
//   stores any, so the compiler loads each shared tap that neighbouring cells
//   of the run read once and keeps it in a register; the functors keep their
//   Taps interface (common.cuh).
// * Edge-free interior tiles. One CTA-uniform test decides whether the whole
//   window (compound halo included) lies inside the grid; such tiles run the
//   sub-steps with no out-of-grid test. Edge tiles write the halo value into
//   every out-of-grid cell at every sub-step.
// * Asynchronous, wide staging (common.cuh: stage_field, which the line
//   cache shares). Rows are staged with 16-byte cp.async where
//   the row's global and shared addresses are 16-byte aligned (each plane is
//   shifted so that both agree modulo 16 bytes), with 4- or 8-byte cp.async
//   for the rest of the row; out-of-grid cells are written with the halo
//   value. 1-byte cells (Conway) are staged with plain loads and stores,
//   which measured faster for them. Loads of one CTA overlap the compute of
//   the other resident on the SM (a persistent grid that prefetched its next
//   tile into a third buffer measured slower; PERF.md).
//
// Narrow storage (common.cuh: Narrow) needs nothing of its own here: its
// functor's T is the storage type, so windows, staging and the core's store
// hold bfloat16 or float8 cells (half or a quarter of float32's shared
// bytes), and its taps convert on read and its sub-steps round on store.
// bfloat16 rows take the 16-byte body where a row is a multiple of 16 bytes
// (W a multiple of 8) and plain 2-byte loads around it; float8 cells are
// staged one per lane, as byte cells are.
//
// Layout of dynamic shared memory, one plane = window rows x pitch + 16
// elements, pitch = window columns rounded up to 16 elements:
//   [ping-pong buffer 0..2)[variant field][plane], then [invariant field][plane].
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "ops/all.cuh"

namespace ss {

constexpr int kTileWarps = 16;  // warps per CTA
constexpr int kTileThreads = 32 * kTileWarps;
constexpr int kMinBlocks = 2;    // CTAs per SM the register budget is cut for

template <class Op>
struct TilePassArgs {
  Fields<Op> f;
  int H, W;            // logical grid extent (storage is H x W, row-major)
  int tile_h, tile_w;  // core tile
  int halo;            // r * p * k
  int steps;           // p * k sub-steps
  int i_start;         // absolute iteration of the pass's first step
  int offset;          // absolute iteration of the call's first step
  int i_end;           // offset + n: steps at or past it leave cells unchanged
  const void* tdv;     // the call's TDV stream: element i - offset for iteration i
  int tiles_x;
  int pitch, plane;    // shared row pitch and plane size, in elements
  bool vec16;          // rows may be staged in 16-byte copies
};

// One sub-step over the window narrowed by m per side: src -> dst (window
// origins), invariant fields at `inv`. A thread computes its run's V cells
// before it stores any, so the compiler loads each tap that the run's cells
// share once.
template <class Op, bool kEdge>
__device__ __forceinline__ void substep(const TilePassArgs<Op>& a, const Op& op,
                                        const typename Op::T* src, typename Op::T* dst,
                                        const typename Op::T* inv, int m, int row0, int col0,
                                        int iteration, int sub, tdv_t<Op> tdv) {
  using T = typename Op::T;
  constexpr int NV = Op::kVariant;
  constexpr int R = Op::kRadius;
  constexpr int V = run_rows<Op>();
  const int WH = a.tile_h + 2 * a.halo;
  const int WW = a.tile_w + 2 * a.halo;
  const int n_runs = (WH - 2 * m + V - 1) / V;
  const int n_chunks = (WW - 2 * m + 31) >> 5;
  int jx = threadIdx.y, jy = 0;
  while (jx >= n_chunks) jx -= n_chunks, ++jy;
  while (jy < n_runs) {
    const int r = min(m + jy * V, WH - m - V);
    const int c = min(m + (jx << 5), WW - m - 32) + threadIdx.x;
    const int gr = row0 + r;
    const int gc = col0 + c;
    const bool col_in = gc >= 0 && gc < a.W;
    T out[V][NV];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (kEdge && (!col_in || gr + k < 0 || gr + k >= a.H)) {
#pragma unroll
        for (int f = 0; f < NV; ++f) out[k][f] = a.f.halo_var[f];
      } else {
        if (!kEdge) {
          // Inside an interior tile every computed cell has all its
          // neighbours in the grid: let the compiler fold edge tests.
          __builtin_assume(gr + k >= R && gr + k < a.H - R && gc >= R && gc < a.W - R);
        }
        const Taps<T, tdv_t<Op>> t{src + (r + k) * a.pitch + c, inv + (r + k) * a.pitch + c,
                                   a.plane, a.plane, a.pitch, gr + k, gc, a.H, a.W, iteration,
                                   sub, tdv};
        op(t, out[k]);
      }
    }
    T* d0 = dst + r * a.pitch + c;
#pragma unroll
    for (int k = 0; k < V; ++k)
#pragma unroll
      for (int f = 0; f < NV; ++f) d0[f * a.plane + k * a.pitch] = out[k][f];
    jx += kTileWarps;
    while (jx >= n_chunks) jx -= n_chunks, ++jy;
  }
}

// The pass's sub-steps on one staged tile; returns the buffer holding the
// result (`cur` or `other`).
template <class Op, bool kEdge>
__device__ __forceinline__ typename Op::T* run_steps(const TilePassArgs<Op>& a, const Op& op,
                                                     typename Op::T* cur, typename Op::T* other,
                                                     const typename Op::T* inv, int row0,
                                                     int col0) {
  constexpr int R = Op::kRadius;
  constexpr int K = Op::kSubiterations;
  for (int s = 0; s < a.steps; ++s) {
    const int iteration = a.i_start + s / K;
    // Past the call's last iteration every cell passes through unchanged,
    // so the core already holds the result (uniform across the CTA).
    if (iteration >= a.i_end) break;
    substep<Op, kEdge>(a, op, cur, other, inv, R * (s + 1), row0, col0, iteration, s % K,
                       read_tdv<Op>(a.tdv, iteration - a.offset));
    __syncthreads();
    typename Op::T* t = cur;
    cur = other;
    other = t;
  }
  return cur;
}

template <class Op>
__global__ void __launch_bounds__(kTileThreads, kMinBlocks)
tile_pass_kernel(const TilePassArgs<Op> a, const Op op) {
  using T = typename Op::T;
  constexpr int NV = Op::kVariant;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ty = blockIdx.x / a.tiles_x;  // once per CTA
  const int tx = blockIdx.x - ty * a.tiles_x;
  const int row0 = ty * a.tile_h - a.halo;
  const int col0 = tx * a.tile_w - a.halo;
  const int WH = a.tile_h + 2 * a.halo;
  const int WW = a.tile_w + 2 * a.halo;
  // Shift every plane so that its rows' shared and global addresses agree
  // modulo 16 bytes.
  const int sh = col0 & (16 / static_cast<int>(sizeof(T)) - 1);
  T* cur = reinterpret_cast<T*>(smem_raw) + sh;  // [2][NV][plane]
  T* other = cur + NV * a.plane;
  T* inv = cur + 2 * NV * a.plane;                // [NI][plane]

#pragma unroll
  for (int f = 0; f < NV; ++f)
    stage_field<kTileWarps>(cur + f * a.plane, a.pitch, a.f.var_in[f], a.f.halo_var[f], row0, col0, WH, WW,
                a.H, a.W, a.vec16);
#pragma unroll
  for (int f = 0; f < Op::kInvariant; ++f)
    stage_field<kTileWarps>(inv + f * a.plane, a.pitch, a.f.inv[f], a.f.halo_inv[f], row0, col0, WH, WW,
                a.H, a.W, a.vec16);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const bool interior = row0 >= 0 && col0 >= 0 && row0 + WH <= a.H && col0 + WW <= a.W;
  const T* res = interior ? run_steps<Op, false>(a, op, cur, other, inv, row0, col0)
                          : run_steps<Op, true>(a, op, cur, other, inv, row0, col0);

  // Write the core back.
  const int gr0 = ty * a.tile_h;
  const int gc0 = tx * a.tile_w;
  const int n_rows = min(a.tile_h, a.H - gr0);
  const int n_cols = min(a.tile_w, a.W - gc0);
  for (int i = threadIdx.y; i < n_rows; i += kTileWarps) {
    const T* s = res + (i + a.halo) * a.pitch + a.halo;
    const long g = static_cast<long>(gr0 + i) * a.W + gc0;
    for (int c = threadIdx.x; c < n_cols; c += 32) {
#pragma unroll
      for (int f = 0; f < NV; ++f) a.f.var_out[f][g + c] = s[f * a.plane + c];
    }
  }
}

template <class Op>
size_t tile_smem_bytes(const TilePassArgs<Op>& a) {
  return sizeof(typename Op::T) * static_cast<size_t>(a.plane) *
         (2 * Op::kVariant + Op::kInvariant);
}

// Fill the launch arguments; returns false for a tile the thread map does
// not take (narrower than a warp or shorter than a run).
template <class Op>
bool tile_args(TilePassArgs<Op>& a, int H, int W, int tile_h, int tile_w, int iters_per_pass) {
  if (tile_w < 32 || tile_h < run_rows<Op>() || iters_per_pass < 0) return false;
  a.H = H;
  a.W = W;
  a.tile_h = tile_h;
  a.tile_w = tile_w;
  a.halo = Op::kRadius * iters_per_pass * Op::kSubiterations;
  a.steps = iters_per_pass * Op::kSubiterations;
  a.tiles_x = (W + tile_w - 1) / tile_w;
  a.pitch = (tile_w + 2 * a.halo + kPitchAlign - 1) / kPitchAlign * kPitchAlign;
  a.plane = (tile_h + 2 * a.halo) * a.pitch + kPitchAlign;
  return true;
}

template <class Op>
int launch_tile_pass(void* const* var_in, void* const* var_out, void* const* inv, int H,
                     int W, int tile_h, int tile_w, int iters_per_pass, int i_start,
                     int offset, int n_iterations, const double* params,
                     const double* halo, const void* tdv, void* stream) {
  using T = typename Op::T;
  TilePassArgs<Op> a;
  if (!tile_args(a, H, W, tile_h, tile_w, iters_per_pass))
    return static_cast<int>(cudaErrorInvalidValue);
  a.f = make_fields<Op>(var_in, var_out, inv, halo);
  a.i_start = i_start;
  a.offset = offset;
  a.i_end = offset + n_iterations;
  a.tdv = tdv;
  bool aligned = (static_cast<size_t>(W) * sizeof(T)) % 16 == 0;
  for (int f = 0; f < Op::kVariant; ++f)
    aligned = aligned && reinterpret_cast<uintptr_t>(var_in[f]) % 16 == 0;
  for (int f = 0; f < Op::kInvariant; ++f)
    aligned = aligned && reinterpret_cast<uintptr_t>(inv[f]) % 16 == 0;
  a.vec16 = aligned;
  const size_t smem = tile_smem_bytes(a);
  cudaError_t e = cudaFuncSetAttribute(tile_pass_kernel<Op>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = a.tiles_x * ((H + tile_h - 1) / tile_h);
  tile_pass_kernel<Op><<<blocks, dim3(32, kTileWarps), smem, static_cast<cudaStream_t>(stream)>>>(
      a, Op::from_params(params));
  return static_cast<int>(cudaGetLastError());
}

// CTAs of tile_pass_kernel<Op> that one SM of the current device holds at
// this geometry: registers, threads and shared memory, as the runtime counts.
template <class Op>
int tile_pass_residency(int tile_h, int tile_w, int iters_per_pass, int* blocks_per_sm) {
  TilePassArgs<Op> a;
  if (!tile_args(a, 1, 1, tile_h, tile_w, iters_per_pass))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = tile_smem_bytes(a);
  cudaError_t e = cudaFuncSetAttribute(tile_pass_kernel<Op>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, tile_pass_kernel<Op>, kTileThreads, smem));
}

// Kind of a stored element: 0 integer, 1 IEEE float, 2 bfloat16, 3 float8
// e4m3 (fn).
template <class T>
constexpr int element_kind() {
  if constexpr (std::is_same<T, Bf16>::value) return 2;
  if constexpr (std::is_same<T, E4m3>::value) return 3;
  return std::is_floating_point<T>::value ? 1 : 0;
}

// Shape of a functor, for the Python wrapper's checks: {radius,
// n_subiterations, n_variant, n_invariant, n_params, element bytes,
// element kind, TDV bytes (0: it takes none), TDV is floating point}.
template <class Op>
int op_info(int* info) {
  using D = tdv_t<Op>;
  constexpr bool kTdv = !std::is_same<D, NoTdv>::value;
  info[0] = Op::kRadius;
  info[1] = Op::kSubiterations;
  info[2] = Op::kVariant;
  info[3] = Op::kInvariant;
  info[4] = Op::kParams;
  info[5] = static_cast<int>(sizeof(typename Op::T));
  info[6] = element_kind<typename Op::T>();
  info[7] = kTdv ? static_cast<int>(sizeof(D)) : 0;
  info[8] = std::is_floating_point<D>::value ? 1 : 0;
  return 0;
}

}  // namespace ss

#define SS_TILE_PASS_ENTRY(name, ...)                                                           \
  extern "C" int ss_tile_pass_##name(void* const* var_in, void* const* var_out,                 \
                                     void* const* inv, int H, int W, int tile_h,                \
                                     int tile_w, int iters_per_pass, int i_start,               \
                                     int offset, int n_iterations, const double* params,        \
                                     const double* halo, const void* tdv, void* stream) {       \
    return ss::launch_tile_pass<__VA_ARGS__>(var_in, var_out, inv, H, W, tile_h, tile_w,        \
                                    iters_per_pass, i_start, offset, n_iterations,              \
                                    params, halo, tdv, stream);                                 \
  }                                                                                             \
  extern "C" int ss_tile_pass_residency_##name(int tile_h, int tile_w,                          \
                                               int iters_per_pass, int* blocks_per_sm) {        \
    return ss::tile_pass_residency<__VA_ARGS__>(tile_h, tile_w, iters_per_pass, blocks_per_sm); \
  }                                                                                             \
  extern "C" int ss_op_info_##name(int* info) { return ss::op_info<__VA_ARGS__>(info); }

SS_FOR_EACH_OP(SS_TILE_PASS_ENTRY)
SS_FOR_EACH_NARROW_OP(SS_TILE_PASS_ENTRY)

extern "C" const char* ss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
