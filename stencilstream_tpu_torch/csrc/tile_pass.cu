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
// core is written back. A functor that declares each sub-step's reach
// (Op::kReach: FDTD's, whose sub-steps read one-sided) gets the larger of its
// low and high reaches summed over the pass as its halo, and sub-step s's
// window narrowed by the low and high reaches of sub-steps 0..s (pass_halo).
// A partial pass stops at the call's last iteration.
// Each step reads its iteration's time-dependent value, if the functor takes
// one, from the call's stream (common.cuh: read_tdv); the steps of a partial
// pass past the call's last iteration read nothing.
//
// What bounds it on Hopper (PERF.md, measured by tile_sweep.py and clock64
// stamps): not device memory. At HotSpot 8192^2, p=8, the law's 56x112 core
// stages a window 1.47x the core, ~15.8 B a cell, which takes about a third
// of the pass; the rest is the sub-steps, which compute whole chunks and
// runs of the narrowing window (1.35 lane-cells per useful cell-step at that
// geometry). With one column a lane they take ~4.4 shared words and ~20
// instructions a cell-step, near the SM's shared-memory and issue rates; the
// vector map of one-field 4-byte cells (below) takes 2.5 words and ~12
// instructions, and latency holds it back: 9 of the 16 warps have a run at
// that tile, each waits on its loads and shuffles, and each sub-step ends at
// a barrier. What the design does about it:
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
// * A vector map for cells of one 4-byte variant field and at most one
//   invariant field, radius 1 (HotSpot, the Jacobi functors), in interior
//   tiles (substep_quads): a lane takes 4 adjacent columns, so a row of taps
//   is one 16-byte load, the side taps come from the neighbouring lanes by
//   shuffles and the outputs go in one 16-byte store. Every other functor,
//   and edge tiles, keep the map above.
// * In-place sub-steps for functors that declare which variant fields each
//   sub-step changes (Op::kWrites: FDTD's leapfrog and convection's straight
//   pseudo-transient functors, which read a changed field only at the cell
//   itself; convection's sub-step 2 also reads boundary velocities next to
//   the cell, cells the sub-step leaves bit-unchanged: ops/convection.cuh).
//   Such a functor's window holds one plane per variant field, not two;
//   sub-step s updates it in place, each cell by exactly one lane (the last
//   chunk and run are not shifted back: the lanes and rows past the window
//   skip), a lane a run of up to 4 rows (in_place_run_rows: as many as keep
//   its outputs within 64 bytes), and stores only the fields of kWrites[s].
//   Sub-step s is a compile-time constant there, so the functor's tests of
//   it fold and the loads of fields the sub-step neither reads nor stores
//   go. The same arithmetic, the same bits. The freed memory buys a larger
//   tile (backends/tiling.py: IN_PLACE_LAW).
// * Edge-free interior tiles. One CTA-uniform test decides whether the whole
//   window (compound halo included) lies inside the grid; such tiles run the
//   sub-steps with no out-of-grid test. Edge tiles write the halo value into
//   every out-of-grid cell at every sub-step.
// * Asynchronous, wide staging (common.cuh: stage_block, which the line
//   cache shares through stage_field). Rows are staged with 16-byte cp.async where
//   the row's global and shared addresses are 16-byte aligned (each plane is
//   shifted so that both agree modulo 16 bytes), with 4- or 8-byte cp.async
//   for the rest of the row; out-of-grid cells are written with the halo
//   value. 1-byte cells (Conway) are staged with plain loads and stores,
//   which measured faster for them. Loads of one CTA overlap the compute of
//   the other resident on the SM (a persistent grid that prefetched its next
//   tile into a third buffer measured slower; PERF.md).
//
// Clamped and extended mode (one entry, one instantiation per functor). The
// pass reads a block of Hs x Ws stored cells whose element (0, 0) sits at
// global (org_r, org_c), which may be negative, in a grid of H x W cells,
// and writes its core: h x w cells at offset (hs, cs) in the block, tiled by
// the launch. Clamped mode, the tiling backend's, is the case block = grid:
// origin 0, no stored halo. Extended mode is the multi-device backends'
// (backends/distributed.py, backends/ring.py, counterparts of the TPU
// kernel's mode="extended", strip_pass.py:96-98, 357-386, 476-484): the
// block is a shard's core with a stored halo from its mesh neighbours, or a
// ring chunk's window. Everything that decides "inside the grid" uses global
// coordinates, and the functor sees them; addresses use block coordinates.
// A window cell outside the grid, or outside the block, is staged as the
// halo value whatever the block holds there (the TPU kernel's entry mask:
// mesh-edge halos and padding rows arrive with any bytes). A window leaves
// the block only where the grid ends or where the tile reaches past the
// core, whose dependency cone (hp cells) the stored halo covers, so no
// core cell reads a substituted value that the grid holds. A pass whose
// steps all lie at or past the call's end writes the staged core back
// (the ring's partial laps, the TPU kernel's force_partial).
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
//   [ping-pong buffer 0..2)[variant field][plane], then [invariant field][plane];
//   in place, one buffer: [variant field][plane], then [invariant field][plane].
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "ops/all.cuh"

namespace ss {

constexpr int kTileWarps = 16;  // warps per CTA
constexpr int kTileThreads = 32 * kTileWarps;
constexpr int kMinBlocks = 2;    // CTAs per SM the register budget is cut for
// Most rows of a thread's run in the in-place sub-steps (PERF.md: of 1, 2, 4
// and 8 within 64 registers, 4 measured fastest for FDTD's cells at 2048^2;
// 8 spills, and more registers at one CTA an SM ran no faster), and the
// bytes of variant fields a run's outputs may hold (in_place_run_rows).
constexpr int kInPlaceRun = 4;
constexpr int kInPlaceRunBytes = 64;
// Cells of at least this many bytes are staged out of line
// (common.cuh: stage_block_outlined): inlined, the block arguments cost the
// HotSpot and Jacobi5 8192^2 passes 2-5% in their sub-steps (PERF.md).
constexpr int kOutlineStagingBytes = 4;
// Rows of a thread's run in the vector map (PERF.md: 8 measured fastest at
// HotSpot's and Jacobi5's 8192^2 tiles, of 4 to 8 and 16).
constexpr int kQuadRun = 8;

// Whether a functor's interior sub-steps take the vector map (substep_quads):
// cells of one 4-byte variant field and at most one invariant field, radius 1.
template <class Op>
__host__ __device__ constexpr bool vector_map() {
  return sizeof(typename Op::T) == 4 && Op::kVariant == 1 && Op::kInvariant <= 1 && Op::kRadius == 1;
}

template <class Op, class = void>
struct DeclaresWrites : std::false_type {};
template <class Op>
struct DeclaresWrites<Op, std::void_t<decltype(Op::kWrites)>> : std::true_type {};

// Whether the tile pass updates a functor's cells in place: it declares the
// variant fields each sub-step changes (Op::kWrites).
template <class Op>
__host__ __device__ constexpr bool in_place() {
  return DeclaresWrites<Op>::value;
}

// Rows of a thread's run in a functor's in-place sub-steps: as many as keep
// the run's outputs within kInPlaceRunBytes (16 registers), at most
// kInPlaceRun, at least one. FDTD's 16 B of variant fields take 4;
// convection's 64 and 80 B of float64 fields take 1, where 4 rows would
// hold 128-160 registers of outputs against the 64 that kMinBlocks leaves a
// thread; its float32 32 and 40 B take 2 and 1.
template <class Op>
__host__ __device__ constexpr int in_place_run_rows() {
  constexpr int rows = kInPlaceRunBytes / static_cast<int>(Op::kVariant * sizeof(typename Op::T));
  return rows < 1 ? 1 : rows > kInPlaceRun ? kInPlaceRun : rows;
}

// Op::kWrites[s] as a scalar constant, which device code can read (an
// element of a host array is not one there).
template <class Op, int s>
constexpr unsigned kWritten = Op::kWrites[s];

template <class Op, class = void>
struct DeclaresReach : std::false_type {};
template <class Op>
struct DeclaresReach<Op, std::void_t<decltype(Op::kReach)>> : std::true_type {};

// Whether a functor declares each sub-step's reach (Op::kReach).
template <class Op>
__host__ __device__ constexpr bool declares_reach() {
  return DeclaresReach<Op>::value;
}

// Sub-step s's reach: Op::kReach[s], or r on both sides.
template <class Op>
constexpr Reach reach(int s) {
  if constexpr (declares_reach<Op>())
    return Op::kReach[s];
  else
    return Reach{Op::kRadius, Op::kRadius};
}

// The low (high) reaches of sub-steps 0..s, summed: how far the window of
// sub-step s of a pass's first iteration is narrowed on the low (high) side.
template <class Op>
constexpr int reach_sum(int s, bool high) {
  int n = 0;
  for (int t = 0; t <= s; ++t) n += high ? reach<Op>(t).hi : reach<Op>(t).lo;
  return n;
}

// Those, and sub-step s's own reach, as scalar constants, which device code
// can read.
template <class Op, int s>
constexpr int kLoSum = reach_sum<Op>(s, false);
template <class Op, int s>
constexpr int kHiSum = reach_sum<Op>(s, true);
template <class Op, int s>
constexpr int kReachLo = reach<Op>(s).lo;
template <class Op, int s>
constexpr int kReachHi = reach<Op>(s).hi;

// The compound halo of a pass of p iterations, per side: the larger of the
// low and the high reaches summed over its p*k sub-steps; r*p*k for a
// functor that declares no reach.
template <class Op>
constexpr int pass_halo(int iters_per_pass) {
  constexpr int lo = kLoSum<Op, Op::kSubiterations - 1>, hi = kHiSum<Op, Op::kSubiterations - 1>;
  return iters_per_pass * (lo > hi ? lo : hi);
}

// Shared planes per variant field: two to ping-pong between, one in place.
template <class Op>
__host__ __device__ constexpr int variant_planes() {
  return in_place<Op>() ? 1 : 2;
}

// One field's window, staged (common.cuh: stage_block).
template <class T>
__device__ __forceinline__ void stage_tile(T* win, int pitch, const T* g, int gpitch, T halo, int row0,
                                           int col0, int WH, int WW, int r_lo, int r_hi, int c_lo,
                                           int c_hi, bool vec16) {
  if constexpr (sizeof(T) >= kOutlineStagingBytes)
    stage_block_outlined<kTileWarps>(win, pitch, g, gpitch, halo, row0, col0, WH, WW, r_lo, r_hi, c_lo,
                                     c_hi, vec16);
  else
    stage_block<kTileWarps>(win, pitch, g, gpitch, halo, row0, col0, WH, WW, r_lo, r_hi, c_lo, c_hi,
                            vec16);
}

// The shared pitch and plane of a window's planes, in elements.
struct Planes {
  int pitch, plane;
};

template <class Op>
struct TilePassArgs {
  Fields<Op> f;
  int H, W;            // global grid extent (coordinates, out-of-grid cells)
  int Ws;              // row pitch of the stored block (Hs x Ws, row-major)
  int org_r, org_c;    // global coordinates of block element (0, 0)
  int row_base;        // global row of tile row 0's window: org_r + hs - halo
  int col_base;        // global column of tile column 0's window: org_c + cs - halo
  int h, w;            // the core's extent: the output is h x w, row-major
  int r_lo, r_hi;      // block rows that are stored and inside the grid
  int c_lo, c_hi;      // block columns that are stored and inside the grid
  int tile_h, tile_w;  // core tile
  int halo;            // pass_halo: r * p * k, or the declared reach's
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
// origins), invariant fields at `inv`, planes laid out by `g` (Planes, or
// the launch arguments themselves). A thread computes its run's V cells
// before it stores any, so the compiler loads each tap that the run's cells
// share once.
template <class Op, bool kEdge, class G>
__device__ __forceinline__ void substep(const TilePassArgs<Op>& a, const G& g, const Op& op,
                                        const typename Op::T* src, typename Op::T* dst,
                                        const typename Op::T* inv, int m, int row0, int col0,
                                        int H, int W, int iteration, int sub, tdv_t<Op> tdv) {
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
    const bool col_in = gc >= 0 && gc < W;
    T out[V][NV];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (kEdge && (!col_in || gr + k < 0 || gr + k >= H)) {
#pragma unroll
        for (int f = 0; f < NV; ++f) out[k][f] = a.f.halo_var[f];
      } else {
        if (!kEdge) {
          // Inside an interior tile every computed cell has all its
          // neighbours in the grid: let the compiler fold edge tests.
          __builtin_assume(gr + k >= R && gr + k < H - R && gc >= R && gc < W - R);
        }
        const Taps<T, tdv_t<Op>> t{src + (r + k) * g.pitch + c, inv + (r + k) * g.pitch + c,
                                   g.plane, g.plane, g.pitch, gr + k, gc, H, W, iteration,
                                   sub, tdv};
        op(t, out[k]);
      }
    }
    T* d0 = dst + r * g.pitch + c;
#pragma unroll
    for (int k = 0; k < V; ++k)
#pragma unroll
      for (int f = 0; f < NV; ++f) d0[f * g.plane + k * g.pitch] = out[k][f];
    jx += kTileWarps;
    while (jx >= n_chunks) jx -= n_chunks, ++jy;
  }
}

// A run of in_place_run_rows<Op>() cells down one column of sub-step kSub
// of an in-place functor, at window row r and column c of the planes at
// `var`: computed, then the fields of kWritten<Op, kSub> stored. kMasked:
// only its first n rows lie in the narrowed window; the others skip. A run
// wholly inside it takes the body without those tests, so the compiler
// loads each tap that its cells share once.
template <class Op, bool kEdge, int kSub, bool kMasked, class G>
__device__ __forceinline__ void in_place_run(const TilePassArgs<Op>& a, const G& g, const Op& op,
                                             typename Op::T* var, const typename Op::T* inv, int r, int c,
                                             int n, int row0, int col0, int H, int W, int iteration,
                                             tdv_t<Op> tdv) {
  using T = typename Op::T;
  constexpr int NV = Op::kVariant;
  constexpr int V = in_place_run_rows<Op>();
  constexpr unsigned kStored = kWritten<Op, kSub>;
  // The sub-step's own reach below and above the cell.
  constexpr int kLo = kReachLo<Op, kSub>, kHi = kReachHi<Op, kSub>;
  const int gr = row0 + r;
  const int gc = col0 + c;
  const bool col_in = gc >= 0 && gc < W;
  T out[V][NV];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (kMasked && k >= n) continue;
    if (kEdge && (!col_in || gr + k < 0 || gr + k >= H)) {
#pragma unroll
      for (int f = 0; f < NV; ++f) out[k][f] = a.f.halo_var[f];
    } else {
      if (!kEdge) {
        // As in substep: an interior tile's computed cells have all the
        // neighbours they read in the grid.
        __builtin_assume(gr + k >= kLo && gr + k < H - kHi && gc >= kLo && gc < W - kHi);
      }
      const Taps<T, tdv_t<Op>> t{var + (r + k) * g.pitch + c, inv + (r + k) * g.pitch + c,
                                 g.plane, g.plane, g.pitch, gr + k, gc, H, W, iteration, kSub, tdv};
      op(t, out[k]);
    }
  }
  T* d0 = var + r * g.pitch + c;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (kMasked && k >= n) continue;
#pragma unroll
    for (int f = 0; f < NV; ++f)
      if (kStored >> f & 1u) d0[f * g.plane + k * g.pitch] = out[k][f];
  }
}

// Sub-step `sub` of iteration j of the pass, for an in-place functor, the
// planes at `var` updated in place over the window narrowed by the reaches
// of the pass's sub-steps so far, this one included: lo on the low side and
// hi on the high side of both axes (r*(s+1) each for a functor that declares
// no reach). Each sub-step is its own instantiation (kSub), chosen by a
// branch that is uniform across the CTA. The thread map is substep's with
// runs of in_place_run_rows<Op>() rows, but each cell of the narrowed window
// is computed by exactly one lane: neither the last chunk nor the last run
// is shifted back inside the window (a shifted lane would read a cell
// another lane has already updated); the lanes and rows past the window
// skip.
template <class Op, bool kEdge, int kSub = 0, class G>
__device__ __forceinline__ void substep_in_place(const TilePassArgs<Op>& a, const G& g, const Op& op,
                                                 typename Op::T* var, const typename Op::T* inv, int j,
                                                 int row0, int col0, int H, int W, int iteration, int sub,
                                                 tdv_t<Op> tdv) {
  constexpr int K = Op::kSubiterations;
  if constexpr (kSub + 1 < K) {
    if (sub != kSub) {
      substep_in_place<Op, kEdge, kSub + 1>(a, g, op, var, inv, j, row0, col0, H, W, iteration, sub, tdv);
      return;
    }
  }
  constexpr int V = in_place_run_rows<Op>();
  const int lo = j * kLoSum<Op, K - 1> + kLoSum<Op, kSub>;
  const int hi = j * kHiSum<Op, K - 1> + kHiSum<Op, kSub>;
  const int WH = a.tile_h + 2 * a.halo;
  const int WW = a.tile_w + 2 * a.halo;
  const int n_runs = (WH - lo - hi + V - 1) / V;
  const int n_chunks = (WW - lo - hi + 31) >> 5;
  int jx = threadIdx.y, jy = 0;
  while (jx >= n_chunks) jx -= n_chunks, ++jy;
  while (jy < n_runs) {
    const int r = lo + jy * V;
    const int c = lo + (jx << 5) + threadIdx.x;
    if (c < WW - hi) {
      if (r + V <= WH - hi)
        in_place_run<Op, kEdge, kSub, false>(a, g, op, var, inv, r, c, V, row0, col0, H, W, iteration, tdv);
      else
        in_place_run<Op, kEdge, kSub, true>(a, g, op, var, inv, r, c, WH - hi - r, row0, col0, H, W, iteration,
                                            tdv);
    }
    jx += kTileWarps;
    while (jx >= n_chunks) jx -= n_chunks, ++jy;
  }
}

// Four 4-byte cells of one shared row, read or written as one 16-byte access.
template <class T>
using Quad = std::conditional_t<std::is_floating_point<T>::value, float4, int4>;

template <class T>
__device__ __forceinline__ void load_quad(const T* p, T (&v)[4]) {
  const Quad<T> q = *reinterpret_cast<const Quad<T>*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

template <class T>
__device__ __forceinline__ void store_quad(T* p, const T (&v)[4]) {
  *reinterpret_cast<Quad<T>*>(p) = Quad<T>{v[0], v[1], v[2], v[3]};
}

// The taps of cell J of a lane's group of 4 in the vector map. Variant taps
// come from the register window: rows up, mid and down, each the group's 4
// cells with the column left of it first and the one right of it last.
// Invariant taps come from the cell row's 16-byte load, or, at another row
// or beyond the group, from shared memory.
template <class T, class D, int J>
struct QuadTaps {
  using Storage = T;
  const T (&up)[6];
  const T (&mid)[6];
  const T (&down)[6];
  const T (&iq)[4];   // invariant field 0 on the cell's row, the group's 4 cells
  const T* inv;       // invariant field 0 at the group's first cell
  int pitch;
  int row, col;       // global coordinates of the cell
  int H, W;
  int iteration;
  int subiteration;
  D tdv;

  __device__ __forceinline__ T v(int, int dr, int dc) const {
    return (dr < 0 ? up : dr > 0 ? down : mid)[1 + J + dc];
  }
  __device__ __forceinline__ T i(int, int dr, int dc) const {
    return dr == 0 && J + dc >= 0 && J + dc < 4 ? iq[J + dc] : inv[dr * pitch + J + dc];
  }
};

// The global column a vector-map cell of an interior tile shows its functor.
// A cell of the narrowed window keeps its own, which lies R or more columns
// inside the grid; an overhanging cell, which may lie at the grid's edge or
// past it and whose value no later sub-step reads, gets the nearest such
// column, so that the functor's edge tests fold.
template <int R>
__device__ __forceinline__ int interior_col(int gc, int W) {
  gc = min(max(gc, R), W - 1 - R);
  __builtin_assume(gc >= R && gc < W - R);
  return gc;
}

// One row of `lane`'s register window: its group's 4 cells at `row + c`
// (one 16-byte load), the column left of them from the lane before
// (`left_src`) and the one right of them from the lane after, by shuffles.
// Lane 0's left column and the right column of lanes at or past `last` are
// `row[oc]`, which each lane loads: lane 0 its own left column, every other
// lane the column right of the last group (one address: a broadcast).
template <class T>
__device__ __forceinline__ void load_window_row(const T* row, int c, int oc, int lane, int left_src, int last,
                                                T (&w)[6]) {
  T q[4];
  load_quad(row + c, q);
  const T o = row[oc];
  const T left = __shfl_sync(0xffffffffu, q[3], left_src);
  const T right = __shfl_down_sync(0xffffffffu, q[0], 1);
  w[0] = lane == 0 ? o : left;
#pragma unroll
  for (int j = 0; j < 4; ++j) w[1 + j] = q[j];
  w[5] = lane >= last ? o : right;
}

// One interior sub-step in the vector map (vector_map<Op>()): src -> dst over
// the window narrowed by m per side, as substep computes it, with another
// thread map. A lane computes a group of 4 adjacent cells on each row of a
// run of kQuadRun rows; a warp takes 32 groups side by side (128 columns),
// so a row's taps are one 16-byte load and its side taps two shuffles, and
// its outputs one 16-byte store. Groups start at the columns c whose shared
// address is 16-byte aligned, (sh + c) % 4 == 0: [gl, gl + 4 * n_groups)
// covers the narrowed window and overhangs it by at most 3 columns a side
// (run_steps says where those land). A chunk of fewer than 32 groups gives
// its surplus lanes its last group, which they compute from the same taps
// and store with the same bits. The run keeps a window of three rows and
// loads one row ahead of the row it computes. `tid` (the thread's index in
// the CTA) and `pitch` come in registers (tile_pass_kernel says why).
template <class Op>
__device__ __forceinline__ void substep_quads(const TilePassArgs<Op>& a, const Op& op,
                                              const typename Op::T* src, typename Op::T* dst,
                                              const typename Op::T* inv, int m, int gl, int n_groups,
                                              int sh, int row0, int col0, int H, int W, int iteration,
                                              int sub, tdv_t<Op> tdv, int tid, int pitch) {
  using T = typename Op::T;
  using D = tdv_t<Op>;
  constexpr int R = Op::kRadius;
  constexpr int V = kQuadRun;
  const int WH = a.tile_h + 2 * a.halo;
  const int n_runs = (WH - 2 * m + V - 1) / V;
  const int n_chunks = (n_groups + 31) >> 5;
  const int lane = tid & 31;
  const int last = min(n_groups, 32) - 1;  // the chunk's last lane with a group of its own
  const int left_src = min(lane, last) - 1;
  int jx = tid >> 5, jy = 0;
  if (n_chunks == 1) {  // the law's tiles: a warp's first run is its index
    jy = jx;
    jx = 0;
  }
  while (jx >= n_chunks) jx -= n_chunks, ++jy;
  while (jy < n_runs) {
    const int r = min(m + jy * V, WH - m - V);
    const int g0 = max(0, min(jx << 5, n_groups - 32));  // the chunk's first group
    const int c = gl + 4 * (g0 + min(lane, last));
    // Lane 0's left column: never before the plane's first element (there
    // only cells of an overhanging group read it).
    const int oc = lane == 0 ? max(c - 1, -sh) : gl + 4 * (g0 + last) + 4;
    const T* s = src + (r - R) * pitch;
    T w[V + 2][6];
    T iq[V][4];
    load_window_row(s, c, oc, lane, left_src, last, w[0]);
    load_window_row(s + pitch, c, oc, lane, left_src, last, w[1]);
    load_window_row(s + 2 * pitch, c, oc, lane, left_src, last, w[2]);
    if constexpr (Op::kInvariant > 0) load_quad(inv + r * pitch + c, iq[0]);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (k + 3 < V + 2) load_window_row(s + (k + 3) * pitch, c, oc, lane, left_src, last, w[k + 3]);
      if constexpr (Op::kInvariant > 0)
        if (k + 1 < V) load_quad(inv + (r + k + 1) * pitch + c, iq[k + 1]);
      const int gr = row0 + r + k;
      // Every run lies inside the narrowed window: all its cells' neighbours
      // lie in the grid.
      __builtin_assume(gr >= R && gr < H - R);
      const T* iv = inv + (r + k) * pitch + c;
      const int gc = col0 + c;
      T out[4];
      op(QuadTaps<T, D, 0>{w[k], w[k + 1], w[k + 2], iq[k], iv, pitch, gr, interior_col<R>(gc, W), H, W,
                           iteration, sub, tdv},
         &out[0]);
      op(QuadTaps<T, D, 1>{w[k], w[k + 1], w[k + 2], iq[k], iv, pitch, gr, interior_col<R>(gc + 1, W), H, W,
                           iteration, sub, tdv},
         &out[1]);
      op(QuadTaps<T, D, 2>{w[k], w[k + 1], w[k + 2], iq[k], iv, pitch, gr, interior_col<R>(gc + 2, W), H, W,
                           iteration, sub, tdv},
         &out[2]);
      op(QuadTaps<T, D, 3>{w[k], w[k + 1], w[k + 2], iq[k], iv, pitch, gr, interior_col<R>(gc + 3, W), H, W,
                           iteration, sub, tdv},
         &out[3]);
      store_quad(dst + (r + k) * pitch + c, out);
    }
    jx += kTileWarps;
    while (jx >= n_chunks) jx -= n_chunks, ++jy;
  }
}

// The pass's sub-steps on one staged tile; returns the buffer holding the
// result (`cur` or `other`; `cur` in place). `sh`: the planes' shift (window column c is
// 16-byte aligned where (sh + c) % 4 == 0).
//
// Interior sub-steps of a functor with vector_map<Op>() take substep_quads,
// whose groups overhang the narrowed window by up to 3 columns a side. An
// overhanging column c in [0, WW) is a cell outside the narrowed window (no
// later sub-step and no write-back reads it); one left of the window lands,
// through the row pitch, at column pitch + c of the row above, one right of
// it at column c - pitch of the row below, or in the padding between rows.
// Such a cell is outside the narrowed window too, or padding, unless the
// window fills the pitch, m = 1 and sh = 2: that sub-step takes substep.
template <class Op, bool kEdge, class G>
__device__ __forceinline__ typename Op::T* run_steps(const TilePassArgs<Op>& a, const G& g,
                                                     const Op& op, typename Op::T* cur,
                                                     typename Op::T* other,
                                                     const typename Op::T* inv, int row0,
                                                     int col0, int H, int W, int sh, int tid, int pitch) {
  constexpr int R = Op::kRadius;
  constexpr int K = Op::kSubiterations;
  static_assert(!declares_reach<Op>() || in_place<Op>(), "only the in-place sub-steps narrow by a declared reach");
  for (int s = 0; s < a.steps; ++s) {
    const int iteration = a.i_start + s / K;
    // Past the call's last iteration every cell passes through unchanged,
    // so the core already holds the result (uniform across the CTA).
    if (iteration >= a.i_end) break;
    const int m = R * (s + 1);
    const tdv_t<Op> tdv = read_tdv<Op>(a.tdv, iteration - a.offset);
    if constexpr (in_place<Op>()) {
      substep_in_place<Op, kEdge>(a, g, op, cur, inv, s / K, row0, col0, H, W, iteration, s % K, tdv);
    } else if constexpr (!kEdge && vector_map<Op>()) {
      const int WW = a.tile_w + 2 * a.halo;
      const int gl = ((sh + m) & ~3) - sh;           // first column of the first group
      const int ge = ((sh + WW - m + 3) & ~3) - sh;  // end of the last group
      if (gl + m >= WW - g.pitch && ge <= g.pitch + m)
        substep_quads<Op>(a, op, cur, other, inv, m, gl, (ge - gl) >> 2, sh, row0, col0, H, W, iteration,
                          s % K, tdv, tid, pitch);
      else
        substep<Op, false>(a, g, op, cur, other, inv, m, row0, col0, H, W, iteration, s % K, tdv);
    } else {
      substep<Op, kEdge>(a, g, op, cur, other, inv, m, row0, col0, H, W, iteration, s % K, tdv);
    }
    __syncthreads();
    if constexpr (!in_place<Op>()) {
      typename Op::T* t = cur;
      cur = other;
      other = t;
    }
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
  // The window's origin in global coordinates and in block ones. (Each
  // global coordinate is one product plus one launch constant, so that the
  // compiler keeps the sub-steps' coordinates in the form of the interior
  // body's assumptions, which let it fold the functors' edge tests.)
  const int row0 = ty * a.tile_h + a.row_base;
  const int col0 = tx * a.tile_w + a.col_base;
  const int br0 = row0 - a.org_r;
  const int bc0 = col0 - a.org_c;
  const int WH = a.tile_h + 2 * a.halo;
  const int WW = a.tile_w + 2 * a.halo;
  // Shift every plane so that its rows' shared and global addresses agree
  // modulo 16 bytes.
  const int sh = bc0 & (16 / static_cast<int>(sizeof(T)) - 1);
  T* cur = reinterpret_cast<T*>(smem_raw) + sh;  // [variant_planes][NV][plane]
  T* other = cur + (variant_planes<Op>() - 1) * NV * a.plane;
  T* inv = cur + variant_planes<Op>() * NV * a.plane;  // [NI][plane]

#pragma unroll
  for (int f = 0; f < NV; ++f)
    stage_tile(cur + f * a.plane, a.pitch, a.f.var_in[f], a.Ws, a.f.halo_var[f], br0, bc0, WH, WW, a.r_lo,
               a.r_hi, a.c_lo, a.c_hi, a.vec16);
#pragma unroll
  for (int f = 0; f < Op::kInvariant; ++f)
    stage_tile(inv + f * a.plane, a.pitch, a.f.inv[f], a.Ws, a.f.halo_inv[f], br0, bc0, WH, WW, a.r_lo,
               a.r_hi, a.c_lo, a.c_hi, a.vec16);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // The grid's extent by value: the interior body's assumptions and the
  // functor's edge tests then read one value, which lets the compiler fold
  // those tests.
  const int H = a.H, W = a.W;
  const bool interior = row0 >= 0 && col0 >= 0 && row0 + WH <= H && col0 + WW <= W;
  // The vector map's thread index and row pitch, read once and held in
  // registers: the compiler would otherwise read them again at each sub-step
  // (S2R, LDC), and those reads wait behind the SM's shared-memory traffic,
  // some 650 cycles before a warp's first load (PERF.md).
  int tid = threadIdx.y * 32 + threadIdx.x, pitch = a.pitch;
  if constexpr (vector_map<Op>()) asm volatile("" : "+r"(tid), "+r"(pitch));
  const T* res;
  if constexpr (is_narrow<T>()) {
    // Narrow cells take the shared pitch and plane as values: read through
    // the launch arguments, they are reloaded after each conversion's inline
    // assembly, a run's rows then share no address registers, and each row
    // loads its taps again (float8 Jacobi5: 40 shared loads a run, not 26).
    // Float32 cells measured faster reading the arguments.
    const Planes g{a.pitch, a.plane};
    res = interior ? run_steps<Op, false>(a, g, op, cur, other, inv, row0, col0, H, W, sh, tid, pitch)
                   : run_steps<Op, true>(a, g, op, cur, other, inv, row0, col0, H, W, sh, tid, pitch);
  } else {
    res = interior ? run_steps<Op, false>(a, a, op, cur, other, inv, row0, col0, H, W, sh, tid, pitch)
                   : run_steps<Op, true>(a, a, op, cur, other, inv, row0, col0, H, W, sh, tid, pitch);
  }

  // Write the tile's core back (core coordinates).
  const int cr0 = ty * a.tile_h;
  const int cc0 = tx * a.tile_w;
  const int n_rows = min(a.tile_h, a.h - cr0);
  const int n_cols = min(a.tile_w, a.w - cc0);
  for (int i = threadIdx.y; i < n_rows; i += kTileWarps) {
    const T* s = res + (i + a.halo) * a.pitch + a.halo;
    const long g = static_cast<long>(cr0 + i) * a.w + cc0;
#pragma unroll
    for (int f = 0; f < NV; ++f) {
      T* const out = a.f.var_out[f] + g;
      const T* const in = s + f * a.plane;
      for (int c = threadIdx.x; c < n_cols; c += 32) out[c] = in[c];
    }
  }
}

template <class Op>
size_t tile_smem_bytes(const TilePassArgs<Op>& a) {
  return sizeof(typename Op::T) * static_cast<size_t>(a.plane) *
         (variant_planes<Op>() * Op::kVariant + Op::kInvariant);
}

// Fill the geometry of a launch over an h x w core; returns false for a tile
// the thread map does not take (narrower than a warp or shorter than a run).
template <class Op>
bool tile_args(TilePassArgs<Op>& a, int h, int w, int tile_h, int tile_w, int iters_per_pass) {
  if (tile_w < 32 || tile_h < run_rows<Op>() || iters_per_pass < 0 || h < 1 || w < 1) return false;
  a.h = h;
  a.w = w;
  a.tile_h = tile_h;
  a.tile_w = tile_w;
  a.halo = pass_halo<Op>(iters_per_pass);
  a.steps = iters_per_pass * Op::kSubiterations;
  a.tiles_x = (w + tile_w - 1) / tile_w;
  a.pitch = (tile_w + 2 * a.halo + kPitchAlign - 1) / kPitchAlign * kPitchAlign;
  a.plane = (tile_h + 2 * a.halo) * a.pitch + kPitchAlign;
  return true;
}

// A block of Hs x Ws stored cells at global (org_r, org_c) in an H x W grid;
// the pass writes its h x w core at (hs, cs) (see the top of this file).
template <class Op>
int launch_tile_pass(void* const* var_in, void* const* var_out, void* const* inv, int Hs,
                     int Ws, int org_r, int org_c, int H, int W, int hs, int cs, int h, int w,
                     int tile_h, int tile_w, int iters_per_pass, int i_start, int offset,
                     int n_iterations, const double* params, const double* halo,
                     const void* tdv, void* stream) {
  using T = typename Op::T;
  TilePassArgs<Op> a;
  if (!tile_args(a, h, w, tile_h, tile_w, iters_per_pass) || hs < 0 || cs < 0 || hs + h > Hs ||
      cs + w > Ws)
    return static_cast<int>(cudaErrorInvalidValue);
  a.H = H;
  a.W = W;
  a.Ws = Ws;
  a.org_r = org_r;
  a.org_c = org_c;
  a.row_base = org_r + hs - a.halo;
  a.col_base = org_c + cs - a.halo;
  a.r_lo = max(0, -org_r);
  a.r_hi = min(Hs, H - org_r);
  a.c_lo = max(0, -org_c);
  a.c_hi = min(Ws, W - org_c);
  a.f = make_fields<Op>(var_in, var_out, inv, halo);
  a.i_start = i_start;
  a.offset = offset;
  a.i_end = offset + n_iterations;
  a.tdv = tdv;
  bool aligned = (static_cast<size_t>(Ws) * sizeof(T)) % 16 == 0;
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
  const int blocks = a.tiles_x * ((h + tile_h - 1) / tile_h);
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
// element kind, TDV bytes (0: it takes none), TDV is floating point,
// the tile pass takes the vector map, the fields each sub-step s writes in
// place (Op::kWrites[s] at bits s * n_variant up; 0: not in place), whether
// it declares its sub-steps' reach, and that reach (sub-step s's low reach
// at bits 8 * s up, its high reach at bits 8 * s + 4 up)}.
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
  info[9] = vector_map<Op>() ? 1 : 0;
  info[10] = 0;
  if constexpr (in_place<Op>())
    for (int s = 0; s < Op::kSubiterations; ++s)
      info[10] |= static_cast<int>(Op::kWrites[s] << (s * Op::kVariant));
  info[11] = declares_reach<Op>() ? 1 : 0;
  info[12] = 0;
  for (int s = 0; s < Op::kSubiterations; ++s) info[12] |= (reach<Op>(s).lo | reach<Op>(s).hi << 4) << (8 * s);
  return 0;
}

}  // namespace ss

#define SS_TILE_PASS_ENTRY(name, ...)                                                           \
  extern "C" int ss_tile_pass_##name(void* const* var_in, void* const* var_out,                 \
                                     void* const* inv, int Hs, int Ws, int org_r, int org_c,    \
                                     int H, int W, int hs, int cs, int h, int w, int tile_h,    \
                                     int tile_w, int iters_per_pass, int i_start,               \
                                     int offset, int n_iterations, const double* params,        \
                                     const double* halo, const void* tdv, void* stream) {       \
    return ss::launch_tile_pass<__VA_ARGS__>(var_in, var_out, inv, Hs, Ws, org_r, org_c, H, W,  \
                                    hs, cs, h, w, tile_h, tile_w, iters_per_pass, i_start,      \
                                    offset, n_iterations, params, halo, tdv, stream);           \
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
