// Line-cache kernel: one pass of p fused iterations (p*k sub-steps) of a
// device functor, streamed down the grid so that no row is computed twice
// within a walk.
//
// Replaces the TPU kernel stencilstream_tpu/backends/line_cache.py:
// LineCachePass (kernel body :243-316, pallas_call in LineCachePass.run),
// which walks non-overlapping full-width row strips in order on one core and
// carries each sub-step level's bottom 2r rows from one strip to the next
// in VMEM scratch; two extended-mode strip passes then patch the top and
// bottom 2*hp rows of the grid (tiling.py:330-406).
//
// What it computes is the function of one tile pass (tile_pass.cu): S =
// min(p, i_end - i_start) * k sub-steps, halo hp = r * S, out-of-grid cells
// held at the halo value at every sub-step, each level reading its
// iteration's time-dependent value, if the functor takes one, from the
// call's stream (common.cuh: read_tdv). What bounds it on Hopper: the
// pass must read every field once and write every variant field once, so
// HBM traffic sets the floor (Jacobi5 at 8192^2, p=8: 8 B/cell, 537 MB, 0.160
// ms at 3.35 TB/s; its 4.8 GFLOP take 0.072 ms at 67 TFLOP/s). The work it
// adds to that floor is the recomputed panel halo (window / panel columns)
// and the warm-up rows above each segment; no row is recomputed within a
// walk. What holds it back (PERF.md): shared-memory bandwidth and issue in
// the levels, as in the tile pass, and staging that only the other CTAs on
// the SM overlap. The design:
//
// * One CTA per (column panel, row segment). A panel is `panel` core
//   columns plus hp recomputed halo columns per side; level s computes the
//   window narrowed by r*s per side, as the tile pass does. The law
//   (backends/line_cache.py) makes the window a whole number of warps wide,
//   so every level covers the same 32-column chunks, and cuts the segments
//   into several waves of CTAs, so that CTAs that walk edge panels or the
//   grid's top and bottom do not set the pass's time.
// * The CTA walks its segment top to bottom, `strip` rows at a time. Level s
//   of strip j covers the rows of its input strip shifted up by r*s, and its
//   vertical taps read level s-1's bottom 2r rows of strip j-1, carried in
//   shared memory, above the strip's own rows. Each level's carry is copied
//   out of its plane and back in once a strip (2r rows against `strip`
//   computed ones); the input strip is staged with its 2r rows above. Two
//   planes per variant field: the staged strip (level 0), then levels
//   alternate between the other plane and it.
// * A 2D thread map without division, as the tile pass's: a warp covers 32
//   consecutive columns of a level, each thread a run of kRun cells down one
//   column (one for multi-field cells), all computed before any is stored,
//   so shared taps that the run's cells share are loaded once (common.cuh:
//   run_cells, which the resident grid runs too). The strip is
//   a whole number of runs; the last chunk of a level is shifted back inside
//   the window, so no lane tests a bound per cell.
// * Edge-free interior runs. One warp-uniform test per run decides whether
//   its cells and their neighbours lie in the grid; such runs compute with
//   no out-of-grid test, and __builtin_assume folds the functors' own edge
//   selects. The other runs write the halo value into every out-of-grid
//   cell at every level, so there is no band patch. (Tests per panel and
//   strip left the edge panels' CTAs on the slow path for their whole walk.)
// * Staging: each strip's input rows, and each level's own rows of an
//   invariant field (HotSpot's power, restaged whole every strip rather than
//   slid on chip), go into shared memory with cp.async (common.cuh:
//   stage_field, 16 bytes wide where aligned; 1-byte cells plain). Prefetching
//   the next strip during this one's levels needs a third plane per variant
//   field; that cost more resident CTAs than the overlap won (PERF.md).
// * Blocks run in parallel and carry nothing between them, so a segment's
//   walk starts `warmup` rows above it (2*hp - 2r rounded up to whole
//   strips; the first segment starts hp rows above the grid, where every
//   cell is halo): a wrong initial carry of level s reaches level S's rows
//   at most r*(S-2) below the walk's first input row, and those are
//   discarded. Output goes to a separate buffer: segments run in parallel
//   and a segment's warm-up reads rows that the segment above writes.
//
// Shared memory, in elements of Op::T, pitch = window columns rounded up to
// 16 elements, the whole shifted so that staged rows' shared and global
// addresses agree modulo 16 bytes:
//   [plane 2][variant field][(2r + strip) x pitch]   plane 0: the staged strip
//   [level 1..S-1][variant field][2r x pitch]         carries
//   [invariant field][(strip + hp + r) x pitch]
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "ops/all.cuh"

namespace ss {

constexpr int kLineWarps = 8;  // warps per CTA
constexpr int kLineThreads = 32 * kLineWarps;

template <class Op>
struct LineCacheArgs {
  Fields<Op> f;
  int H, W;      // logical grid extent (storage is H x W, row-major)
  int strip;     // rows computed per level and step of the walk
  int panel;     // core columns per CTA
  int segment;   // output rows per CTA
  int warmup;    // rows walked above a segment (not the first) before its first output row
  int halo;      // r * steps
  int steps;     // active sub-steps of this pass
  int i_start;   // absolute iteration of the pass's first step
  int offset;    // absolute iteration of the call's first step
  const void* tdv;  // the call's TDV stream: element i - offset for iteration i
  int pitch;     // shared row pitch, in elements
  int vplane;    // elements of one variant field's plane: (2r + strip) x pitch
  int iplane;    // elements of one invariant field's plane: (strip + hp + r) x pitch
  bool vec16;    // rows may be staged in 16-byte copies
};

template <class Op>
void line_cache_geometry(LineCacheArgs<Op>& a, int strip, int panel, int steps) {
  constexpr int R = Op::kRadius;
  a.strip = strip;
  a.panel = panel;
  a.steps = steps;
  a.halo = R * steps;
  a.pitch = (panel + 2 * a.halo + kPitchAlign - 1) / kPitchAlign * kPitchAlign;
  a.vplane = (2 * R + strip) * a.pitch;
  a.iplane = (strip + a.halo + R) * a.pitch;
}

template <class Op>
size_t line_cache_smem_bytes(const LineCacheArgs<Op>& a) {
  constexpr int NV = Op::kVariant;
  const size_t carries = static_cast<size_t>(a.steps > 1 ? a.steps - 1 : 0) * NV * 2 *
                         Op::kRadius * a.pitch;
  const size_t elems = 2 * NV * static_cast<size_t>(a.vplane) + carries +
                       Op::kInvariant * static_cast<size_t>(a.iplane);
  return elems * sizeof(typename Op::T) + 16;  // + the alignment shift
}

// Level s of one strip: the window narrowed by m = r*s per side, src ->
// dst (variant planes, row 2r = the strip's row 0), invariant fields at
// `inv` (plane row r = the level's row 0). row0, col0: global coordinates of
// the level's row 0 and the window's column 0.
template <class Op>
__device__ __forceinline__ void level(const LineCacheArgs<Op>& a, const Op& op,
                                      const typename Op::T* src, typename Op::T* dst,
                                      const typename Op::T* inv, int m, int row0, int col0,
                                      int iteration, int sub, tdv_t<Op> tdv) {
  constexpr int R = Op::kRadius;
  constexpr int V = run_rows<Op>();
  const int ww = a.panel + 2 * a.halo;
  const int n_runs = a.strip / V;
  const int n_chunks = (ww - 2 * m + 31) >> 5;
  int jx = threadIdx.y, jy = 0;
  while (jx >= n_chunks) jx -= n_chunks, ++jy;
  while (jy < n_runs) {
    const int r = jy * V;
    const int c0 = min(m + (jx << 5), ww - m - 32);
    const int gr = row0 + r;
    const int gc0 = col0 + c0;
    // Warp-uniform: the run's cells and their neighbours lie in the grid.
    const bool inside = gr >= R && gr + V <= a.H - R && gc0 >= R && gc0 + 32 <= a.W - R;
    const int c = c0 + threadIdx.x;
    const typename Op::T* s = src + (r + R) * a.pitch + c;
    typename Op::T* d = dst + (2 * R + r) * a.pitch + c;
    const typename Op::T* i = inv + (r + R) * a.pitch + c;
    if (inside)
      run_cells<Op, true, true, false>(op, a.f, s, d, i, a.vplane, a.iplane, a.pitch, gr, gc0 + threadIdx.x,
                           a.H, a.W, iteration, sub, tdv);
    else
      run_cells<Op, false, false, true>(op, a.f, s, d, i, a.vplane, a.iplane, a.pitch, gr, gc0 + threadIdx.x,
                          a.H, a.W, iteration, sub, tdv);
    jx += kLineWarps;
    while (jx >= n_chunks) jx -= n_chunks, ++jy;
  }
}

// A flat copy of n elements by the whole CTA.
template <class T>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int n) {
  for (int e = threadIdx.y * 32 + threadIdx.x; e < n; e += kLineThreads) dst[e] = src[e];
}

// The levels of strip j: level 0 in `src` (staged), the other plane `dst`,
// carries `carry`, invariant rows `inv` (plane row 0 = global row g_in -
// hp - r); returns the plane holding level S.
template <class Op>
__device__ __forceinline__ typename Op::T* run_levels(const LineCacheArgs<Op>& a, const Op& op,
                                                      typename Op::T* src, typename Op::T* dst,
                                                      typename Op::T* carry,
                                                      const typename Op::T* inv, int g_in,
                                                      int x0) {
  constexpr int NV = Op::kVariant;
  constexpr int R = Op::kRadius;
  constexpr int K = Op::kSubiterations;
  const int n_carry = 2 * R * a.pitch;
  int iteration = a.i_start, sub = 0;
  tdv_t<Op> tdv{};
  for (int s = 1; s <= a.steps; ++s) {
    // The pass's active steps all lie before offset + n (launch_line_cache).
    if (sub == 0) tdv = read_tdv<Op>(a.tdv, iteration - a.offset);
    level(a, op, src, dst, inv + (a.halo - R * s) * a.pitch, R * s, g_in - R * s, x0, iteration,
          sub, tdv);
    // Carry level s-1's bottom 2r rows to the next strip, and put level s's
    // from the previous strip above the rows this level wrote.
#pragma unroll
    for (int f = 0; f < NV; ++f) {
      if (s >= 2)
        copy_rows(carry + ((s - 2) * NV + f) * n_carry, src + f * a.vplane + a.strip * a.pitch,
                  n_carry);
      if (s < a.steps) copy_rows(dst + f * a.vplane, carry + ((s - 1) * NV + f) * n_carry, n_carry);
    }
    __syncthreads();
    typename Op::T* t = src;
    src = dst;
    dst = t;
    if (++sub == K) sub = 0, ++iteration;
  }
  return src;
}

template <class Op>
__global__ void __launch_bounds__(kLineThreads)
line_cache_kernel(const LineCacheArgs<Op> a, const Op op) {
  using T = typename Op::T;
  constexpr int NV = Op::kVariant;
  constexpr int NI = Op::kInvariant;
  constexpr int R = Op::kRadius;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int ts = a.strip;
  const int hp = a.halo;
  const int ww = a.panel + 2 * hp;
  const int x0 = blockIdx.x * a.panel - hp;  // global column of window column 0
  const int y0 = blockIdx.y * a.segment;     // first output row of the segment
  const int y1 = min(y0 + a.segment, a.H);
  const int warm = blockIdx.y == 0 ? hp : a.warmup;
  const int r0 = y0 - warm + hp;  // global row of the first strip's first input row
  const int n_strips = (warm + (y1 - y0) + ts - 1) / ts;
  const int sh = x0 & (16 / static_cast<int>(sizeof(T)) - 1);
  T* plane = reinterpret_cast<T*>(smem_raw) + sh;                 // [2][NV][vplane]
  T* carry = plane + 2 * NV * a.vplane;                           // [S-1][NV][2r x pitch]
  T* inv = carry + (a.steps > 1 ? a.steps - 1 : 0) * NV * 2 * R * a.pitch;  // [NI][iplane]

  for (int j = 0; j < n_strips; ++j) {
    const int g_in = r0 + j * ts;  // global row of this strip's first input row
    // Stage the strip's input rows g_in - 2r .. g_in + strip - 1 and its
    // invariant rows g_in - hp - r .. g_in + strip - 1, once strip j-1's
    // store has read the planes.
    __syncthreads();
#pragma unroll
    for (int f = 0; f < NV; ++f)
      stage_field<kLineWarps>(plane + f * a.vplane, a.pitch, a.f.var_in[f], a.f.halo_var[f],
                              g_in - 2 * R, x0, ts + 2 * R, ww, a.H, a.W, a.vec16);
#pragma unroll
    for (int f = 0; f < NI; ++f)
      stage_field<kLineWarps>(inv + f * a.iplane, a.pitch, a.f.inv[f], a.f.halo_inv[f],
                              g_in - hp - R, x0, ts + hp + R, ww, a.H, a.W, a.vec16);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    const T* res = run_levels(a, op, plane, plane + NV * a.vplane, carry, inv, g_in, x0);

    // Store the rows of the segment that this strip finished (level S, core
    // columns).
    const int g_out = g_in - hp;
    const int gc0 = blockIdx.x * a.panel;
    const int n_cols = min(a.panel, a.W - gc0);
    for (int i = threadIdx.y; i < ts; i += kLineWarps) {
      const int gr = g_out + i;
      if (gr < y0 || gr >= y1) continue;
      const T* s = res + (2 * R + i) * a.pitch + hp;
      const long g = static_cast<long>(gr) * a.W + gc0;
      for (int c = threadIdx.x; c < n_cols; c += 32) {
#pragma unroll
        for (int f = 0; f < NV; ++f) a.f.var_out[f][g + c] = s[f * a.vplane + c];
      }
    }
  }
}

// Fill the launch geometry; returns false for one the kernel does not take:
// a strip that is not a whole number of runs or holds fewer than 2r rows, a
// panel narrower than a warp.
template <class Op>
bool line_cache_args(LineCacheArgs<Op>& a, int strip, int panel, int segment, int steps) {
  constexpr int R = Op::kRadius;
  if (2 * R > strip || strip % run_rows<Op>() != 0 || panel < 32 || segment < 1 || steps < 0)
    return false;
  line_cache_geometry(a, strip, panel, steps);
  a.segment = segment;
  // A wrong initial carry reaches r*(S-2) rows below the walk's first input
  // row at level S (see above); round up to whole strips.
  const int need = max(0, 2 * a.halo - 2 * R);
  a.warmup = (need + strip - 1) / strip * strip;
  return true;
}

template <class Op>
int launch_line_cache(void* const* var_in, void* const* var_out, void* const* inv, int H, int W,
                      int strip, int panel, int segment, int iters_per_pass, int i_start,
                      int offset, int n_iterations, const double* params, const double* halo,
                      const void* tdv, void* stream) {
  using T = typename Op::T;
  // Steps at or past offset + n leave every cell unchanged: a partial pass
  // walks with fewer levels (and a narrower halo) uniformly.
  const int active = max(0, min(iters_per_pass, offset + n_iterations - i_start));
  LineCacheArgs<Op> a;
  if (iters_per_pass < 0 || !line_cache_args(a, strip, panel, segment, active * Op::kSubiterations))
    return static_cast<int>(cudaErrorInvalidValue);
  a.f = make_fields<Op>(var_in, var_out, inv, halo);
  a.H = H;
  a.W = W;
  a.i_start = i_start;
  a.offset = offset;
  a.tdv = tdv;
  bool aligned = (static_cast<size_t>(W) * sizeof(T)) % 16 == 0;
  for (int f = 0; f < Op::kVariant; ++f)
    aligned = aligned && reinterpret_cast<uintptr_t>(var_in[f]) % 16 == 0;
  for (int f = 0; f < Op::kInvariant; ++f)
    aligned = aligned && reinterpret_cast<uintptr_t>(inv[f]) % 16 == 0;
  a.vec16 = aligned;
  const size_t smem = line_cache_smem_bytes(a);
  cudaError_t e = cudaFuncSetAttribute(line_cache_kernel<Op>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((W + panel - 1) / panel, (H + segment - 1) / segment);
  line_cache_kernel<Op><<<grid, dim3(32, kLineWarps), smem, static_cast<cudaStream_t>(stream)>>>(
      a, Op::from_params(params));
  return static_cast<int>(cudaGetLastError());
}

// CTAs of line_cache_kernel<Op> that one SM of the current device holds at
// this geometry: registers, threads and shared memory, as the runtime counts.
template <class Op>
int line_cache_residency(int strip, int panel, int steps, int* blocks_per_sm) {
  LineCacheArgs<Op> a;
  if (!line_cache_args(a, strip, panel, 1, steps)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = line_cache_smem_bytes(a);
  cudaError_t e = cudaFuncSetAttribute(line_cache_kernel<Op>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, line_cache_kernel<Op>, kLineThreads, smem));
}

}  // namespace ss

#define SS_LINE_CACHE_ENTRY(name, Op)                                                         \
  extern "C" int ss_line_cache_##name(void* const* var_in, void* const* var_out,             \
                                      void* const* inv, int H, int W, int strip, int panel,   \
                                      int segment, int iters_per_pass, int i_start,           \
                                      int offset, int n_iterations, const double* params,     \
                                      const double* halo, const void* tdv, void* stream) {    \
    return ss::launch_line_cache<Op>(var_in, var_out, inv, H, W, strip, panel, segment,       \
                                     iters_per_pass, i_start, offset, n_iterations, params,   \
                                     halo, tdv, stream);                                      \
  }                                                                                           \
  extern "C" int ss_line_cache_residency_##name(int strip, int panel, int steps,             \
                                                int* blocks_per_sm) {                         \
    return ss::line_cache_residency<Op>(strip, panel, steps, blocks_per_sm);                  \
  }

SS_FOR_EACH_OP(SS_LINE_CACHE_ENTRY)
