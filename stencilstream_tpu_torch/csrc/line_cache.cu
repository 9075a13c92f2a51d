// Line-cache kernel: one pass of p fused iterations (p*k sub-steps) of a
// device functor, streamed down the grid so that no row is read twice from
// device memory or computed twice within a walk.
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
// held at the halo value at every sub-step. What bounds it on Hopper: the
// pass must read every field once and write every variant field once, so
// HBM traffic sets the floor (Jacobi5 at 8192^2, p=8: 8 B/cell, 537 MB, 0.160
// ms at 3.35 TB/s; its 4.8 GFLOP take 0.072 ms at 67 TFLOP/s). The design:
//
// * One CTA per (column panel, row segment). A panel is `panel` core
//   columns plus hp recomputed halo columns per side; level s computes the
//   window narrowed by r*s per side, as the tile pass does.
// * The CTA walks its segment top to bottom, `strip` rows at a time. Per
//   variant field it keeps two (2r + strip)-row planes, ping-ponged between
//   sub-step levels, and S carries of 2r rows: level s of strip j covers
//   the rows of its input strip shifted up by r*s, and its vertical taps
//   read the carried bottom 2r rows of level s-1 from strip j-1 above the
//   strip's own rows. Each strip stages only its `strip` new input rows.
// * Blocks run in parallel and carry nothing between them, so a segment's
//   walk starts `warmup` rows above it (2*hp + 2r rounded to whole strips;
//   the first segment starts hp rows above the grid, where every cell is
//   halo): a wrong initial carry reaches at most 2*hp output rows, and
//   those are discarded. Every level re-masks out-of-grid cells to the
//   halo value, so there is no band patch.
// * Invariant fields (HotSpot's power) are read at each level's own rows
//   from a (strip + hp + 2r)-row plane that slides down the walk: each
//   strip copies the overlap on chip and stages only its new rows.
// * Output goes to a separate buffer: segments run in parallel and a
//   segment's warm-up reads rows that the segment above writes.
// Loads and stores are plain; cp.async/TMA staging is later work.
//
// Shared memory, in elements of Op::T:
//   [variant field][plane 2][(2r + strip) x WW]
//   [variant field][level S][2r x WW]
//   [invariant field][plane 2][(strip + hp + 2r) x WW]      WW = panel + 2*hp
#include <cuda_runtime.h>

#include "common.cuh"
#include "ops/all.cuh"

namespace ss {

constexpr int kLineThreads = 256;

template <class Op>
struct LineCacheArgs {
  Fields<Op> f;
  int H, W;      // logical grid extent (storage is H x W, row-major)
  int strip;     // rows staged per step of the walk (>= 2r)
  int panel;     // core columns per CTA
  int segment;   // output rows per CTA
  int warmup;    // rows walked above the segment before its first output row
  int halo;      // r * steps
  int steps;     // active sub-steps of this pass
  int i_start;   // absolute iteration of the pass's first step
};

template <class Op>
size_t line_cache_smem_bytes(int strip, int panel, int steps) {
  constexpr int R = Op::kRadius;
  const size_t hp = static_cast<size_t>(R) * steps;
  const size_t ww = panel + 2 * hp;
  const size_t elems = Op::kVariant * (2 * (strip + 2 * R) + steps * 2 * R) * ww +
                       Op::kInvariant * 2 * (strip + hp + 2 * R) * ww;
  return elems * sizeof(typename Op::T);
}

template <class Op>
__global__ void __launch_bounds__(kLineThreads)
line_cache_kernel(const LineCacheArgs<Op> a, const Op op) {
  using T = typename Op::T;
  constexpr int NV = Op::kVariant;
  constexpr int NI = Op::kInvariant;
  constexpr int R = Op::kRadius;
  constexpr int K = Op::kSubiterations;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int ts = a.strip;
  const int hp = a.halo;
  const int ww = a.panel + 2 * hp;
  const int plane = (2 * R + ts) * ww;  // one variant plane: carry rows, then strip rows
  const int carry_n = 2 * R * ww;       // one level's carry
  const int irows = ts + hp + 2 * R;    // rows of an invariant plane
  const int iplane = irows * ww;
  T* var = reinterpret_cast<T*>(smem_raw);  // [NV][2][plane]
  T* carry = var + NV * 2 * plane;          // [NV][steps][carry_n]
  T* inv = carry + NV * a.steps * carry_n;  // [NI][2][iplane]

  const int x0 = blockIdx.x * a.panel - hp;  // global column of window column 0
  const int y0 = blockIdx.y * a.segment;     // first output row of the segment
  const int y1 = min(y0 + a.segment, a.H);
  // The first segment starts hp rows above the grid: its carries, all above
  // row 0, then hold exactly the halo value they start with.
  const int warm = blockIdx.y == 0 ? hp : a.warmup;
  const int r0 = y0 - warm + hp;  // global row of the first strip's first input row
  const int n_strips = (warm + (y1 - y0) + ts - 1) / ts;

  for (int idx = threadIdx.x; idx < NV * a.steps * carry_n; idx += blockDim.x)
    carry[idx] = a.f.halo_var[idx / (a.steps * carry_n)];
  __syncthreads();

  int load = 0;  // variant plane that takes the next strip's input rows
  int iq = 0;    // invariant plane of the current strip
  for (int j = 0; j < n_strips; ++j) {
    const int g_in = r0 + j * ts;  // global row of this strip's first input row

    // Stage the strip's input rows below level 0's carry; outside the grid
    // every field holds its halo value.
    for (int idx = threadIdx.x; idx < ts * ww; idx += blockDim.x) {
      const int i = idx / ww;
      const int c = idx - i * ww;
      const int gr = g_in + i;
      const int gc = x0 + c;
      const bool in = gr >= 0 && gr < a.H && gc >= 0 && gc < a.W;
      const long gi = static_cast<long>(gr) * a.W + gc;
#pragma unroll
      for (int f = 0; f < NV; ++f)
        var[(f * 2 + load) * plane + (2 * R + i) * ww + c] = in ? a.f.var_in[f][gi] : a.f.halo_var[f];
    }
    if (a.steps > 0) {
      for (int idx = threadIdx.x; idx < NV * carry_n; idx += blockDim.x) {
        const int f = idx / carry_n;
        const int e = idx - f * carry_n;
        var[(f * 2 + load) * plane + e] = carry[f * a.steps * carry_n + e];
      }
    }
    // Slide the invariant planes down by one strip: row k holds global row
    // g_in - hp - R + k. Keep the overlap, stage the new rows.
    if (NI > 0) {
      const int prev = iq;
      iq = j == 0 ? 0 : iq ^ 1;
      const int keep = j == 0 ? 0 : irows - ts;
      const int g_top = g_in - hp - R;
      for (int idx = threadIdx.x; idx < iplane; idx += blockDim.x) {
        const int k = idx / ww;
        const int c = idx - k * ww;
        if (k < keep) {
#pragma unroll
          for (int f = 0; f < NI; ++f)
            inv[(f * 2 + iq) * iplane + idx] = inv[(f * 2 + prev) * iplane + idx + ts * ww];
        } else {
          const int gr = g_top + k;
          const int gc = x0 + c;
          const bool in = gr >= 0 && gr < a.H && gc >= 0 && gc < a.W;
          const long gi = static_cast<long>(gr) * a.W + gc;
#pragma unroll
          for (int f = 0; f < NI; ++f)
            inv[(f * 2 + iq) * iplane + idx] = in ? a.f.inv[f][gi] : a.f.halo_inv[f];
        }
      }
    }
    __syncthreads();

    int src = load;
    for (int s = 1; s <= a.steps; ++s) {
      const int dst = src ^ 1;
      const int iteration = a.i_start + (s - 1) / K;
      const int sub = (s - 1) % K;
      const int g_lvl = g_in - s * R;  // global row of level s's strip row 0
      // Level s is valid r*s columns in from either window edge.
      const int m = R * s;
      const int cw = ww - 2 * m;
      const T* sp = var + src * plane;
      for (int idx = threadIdx.x; idx < ts * cw; idx += blockDim.x) {
        const int i = idx / cw;
        const int c = m + (idx - i * cw);
        const int gr = g_lvl + i;
        const int gc = x0 + c;
        T out[NV];
        if (gr < 0 || gr >= a.H || gc < 0 || gc >= a.W) {
#pragma unroll
          for (int f = 0; f < NV; ++f) out[f] = a.f.halo_var[f];
        } else {
          // Level s row i reads level s-1 rows i..i+2r of the carry-extended
          // plane (centre at row i + r); the invariant plane holds the
          // level's own row at hp + r - r*s + i.
          const Taps<T> t{sp + (i + R) * ww + c,
                          inv + iq * iplane + (hp + R - R * s + i) * ww + c,
                          2L * plane, 2L * iplane, ww, gr, gc, a.H, a.W, iteration, sub};
          op(t, out);
        }
#pragma unroll
        for (int f = 0; f < NV; ++f) var[(f * 2 + dst) * plane + (2 * R + i) * ww + c] = out[f];
      }
      // Carry level s-1's bottom 2r rows to the next strip, and put level
      // s's carry above the rows this level writes (the next level reads it).
      for (int idx = threadIdx.x; idx < NV * carry_n; idx += blockDim.x) {
        const int f = idx / carry_n;
        const int e = idx - f * carry_n;
        carry[(f * a.steps + s - 1) * carry_n + e] = var[(f * 2 + src) * plane + ts * ww + e];
        if (s < a.steps) var[(f * 2 + dst) * plane + e] = carry[(f * a.steps + s) * carry_n + e];
      }
      __syncthreads();
      src = dst;
    }

    // Store the rows of the segment that this strip finished (level S, core
    // columns). The next strip stages into the other plane, so no barrier
    // is needed before it.
    const int g_out = g_in - hp;
    for (int idx = threadIdx.x; idx < ts * a.panel; idx += blockDim.x) {
      const int i = idx / a.panel;
      const int cc = idx - i * a.panel;
      const int gr = g_out + i;
      const int gc = blockIdx.x * a.panel + cc;
      if (gr >= y0 && gr < y1 && gc < a.W) {
        const long gi = static_cast<long>(gr) * a.W + gc;
#pragma unroll
        for (int f = 0; f < NV; ++f)
          a.f.var_out[f][gi] = var[(f * 2 + src) * plane + (2 * R + i) * ww + hp + cc];
      }
    }
    load = src ^ 1;
  }
}

template <class Op>
int launch_line_cache(void* const* var_in, void* const* var_out, void* const* inv, int H, int W,
                      int strip, int panel, int segment, int iters_per_pass, int i_start,
                      int offset, int n_iterations, const double* params, const double* halo,
                      void* stream) {
  constexpr int R = Op::kRadius;
  if (2 * R > strip || panel < 1 || segment < 1 || iters_per_pass < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  LineCacheArgs<Op> a;
  a.f = make_fields<Op>(var_in, var_out, inv, halo);
  a.H = H;
  a.W = W;
  a.strip = strip;
  a.panel = panel;
  a.segment = segment;
  // Steps at or past offset + n leave every cell unchanged: a partial pass
  // walks with fewer levels (and a narrower halo) uniformly.
  const int active = max(0, min(iters_per_pass, offset + n_iterations - i_start));
  a.steps = active * Op::kSubiterations;
  a.halo = R * a.steps;
  a.warmup = (2 * a.halo + 2 * R + strip - 1) / strip * strip;
  a.i_start = i_start;
  const size_t smem = line_cache_smem_bytes<Op>(strip, panel, a.steps);
  cudaError_t e = cudaFuncSetAttribute(line_cache_kernel<Op>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((W + panel - 1) / panel, (H + segment - 1) / segment);
  line_cache_kernel<Op><<<grid, kLineThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, Op::from_params(params));
  return static_cast<int>(cudaGetLastError());
}

// CTAs of line_cache_kernel<Op> that one SM of the current device holds at
// this geometry: registers, threads and shared memory, as the runtime counts.
template <class Op>
int line_cache_residency(int strip, int panel, int steps, int* blocks_per_sm) {
  const size_t smem = line_cache_smem_bytes<Op>(strip, panel, steps);
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
                                      const double* halo, void* stream) {                     \
    return ss::launch_line_cache<Op>(var_in, var_out, inv, H, W, strip, panel, segment,       \
                                     iters_per_pass, i_start, offset, n_iterations, params,   \
                                     halo, stream);                                           \
  }                                                                                           \
  extern "C" int ss_line_cache_residency_##name(int strip, int panel, int steps,             \
                                                int* blocks_per_sm) {                         \
    return ss::line_cache_residency<Op>(strip, panel, steps, blocks_per_sm);                  \
  }

SS_FOR_EACH_OP(SS_LINE_CACHE_ENTRY)
