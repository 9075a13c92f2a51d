// Tile-pass kernel: p fused iterations (p*k sub-steps) of a device functor
// over 2D tiles, one CTA per tile, one launch per pass.
//
// Replaces the TPU kernel stencilstream_tpu/backends/strip_pass.py:StripPass
// (kernel body built in __init__, pallas_call in StripPass.run), which fuses
// p iterations over full-width row strips held in VMEM.
//
// What bounds it on Hopper: each CTA stages a (TH+2hp) x (TW+2hp) window,
// hp = r*p*k, of every field into shared memory once per pass, so global
// traffic per cell-iteration is about (2*variant + invariant) bytes x window
// overlap / p -- for HotSpot at 64x64 tiles and p=8, some 2 B, far below the
// card's memory bandwidth. Every sub-step then reads five temp taps plus the
// power centre and writes one value per cell, all in shared memory: about
// 28 B of shared-memory traffic and ~10 flops per cell-step, plus the
// redundant halo ring (the window shrinks by r per side each sub-step, so the
// average window is ~1.2x the core at p=8). Shared-memory bandwidth and
// instruction issue bound it. The design keeps the whole pass on chip, skips
// the stale ring that grows from the window edge (each sub-step computes only
// the cells the next one needs), and stops a partial pass at the call's last
// iteration instead of copying cells through.
//
// Layout of dynamic shared memory, one plane = window rows x window cols:
//   [variant field][ping-pong buffer][plane], then [invariant field][plane].
// Cells outside the grid hold the halo value at every sub-step.
#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"
#include "ops/all.cuh"

namespace ss {

constexpr int kTileThreads = 512;

template <class Op>
struct TilePassArgs {
  Fields<Op> f;
  int H, W;            // logical grid extent (storage is H x W, row-major)
  int tile_h, tile_w;  // core tile
  int halo;            // r * p * k
  int steps;           // p * k sub-steps
  int i_start;         // absolute iteration of the pass's first step
  int i_end;           // offset + n: steps at or past it leave cells unchanged
};

template <class Op>
__global__ void __launch_bounds__(kTileThreads)
tile_pass_kernel(const TilePassArgs<Op> a, const Op op) {
  using T = typename Op::T;
  constexpr int NV = Op::kVariant;
  constexpr int NI = Op::kInvariant;
  constexpr int R = Op::kRadius;
  constexpr int K = Op::kSubiterations;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* var_base = reinterpret_cast<T*>(smem_raw);

  const int WH = a.tile_h + 2 * a.halo;
  const int WW = a.tile_w + 2 * a.halo;
  const int plane = WH * WW;
  T* inv_base = var_base + 2 * NV * plane;
  const int row0 = blockIdx.y * a.tile_h - a.halo;  // global row of window row 0
  const int col0 = blockIdx.x * a.tile_w - a.halo;

  // Stage the window; outside the grid every field holds its halo value.
  for (int idx = threadIdx.x; idx < plane; idx += blockDim.x) {
    const int wr = idx / WW;
    const int wc = idx - wr * WW;
    const int gr = row0 + wr;
    const int gc = col0 + wc;
    const bool in = gr >= 0 && gr < a.H && gc >= 0 && gc < a.W;
    const long gi = static_cast<long>(gr) * a.W + gc;
#pragma unroll
    for (int f = 0; f < NV; ++f)
      var_base[f * 2 * plane + idx] = in ? a.f.var_in[f][gi] : a.f.halo_var[f];
#pragma unroll
    for (int f = 0; f < NI; ++f)
      inv_base[f * plane + idx] = in ? a.f.inv[f][gi] : a.f.halo_inv[f];
  }
  __syncthreads();

  int cur = 0;
  for (int s = 0; s < a.steps; ++s) {
    const int iteration = a.i_start + s / K;
    // Past the call's last iteration every cell passes through unchanged,
    // so the core already holds the result (uniform across the CTA).
    if (iteration >= a.i_end) break;
    const int sub = s % K;
    // After s+1 sub-steps the outer R*(s+1) ring of the window is stale;
    // compute only the cells inside it.
    const int m = R * (s + 1);
    const int ch = WH - 2 * m;
    const int cw = WW - 2 * m;
    const T* src = var_base + cur * plane;
    T* dst = var_base + (cur ^ 1) * plane;
    for (int idx = threadIdx.x; idx < ch * cw; idx += blockDim.x) {
      const int wr = m + idx / cw;
      const int wc = m + idx % cw;
      const int gr = row0 + wr;
      const int gc = col0 + wc;
      const int li = wr * WW + wc;
      T out[NV];
      if (gr < 0 || gr >= a.H || gc < 0 || gc >= a.W) {
#pragma unroll
        for (int f = 0; f < NV; ++f) out[f] = a.f.halo_var[f];
      } else {
        const Taps<T> t{src + li, inv_base + li, 2L * plane, static_cast<long>(plane),
                        WW, gr, gc, a.H, a.W, iteration, sub};
        op(t, out);
      }
#pragma unroll
      for (int f = 0; f < NV; ++f) dst[f * 2 * plane + li] = out[f];
    }
    __syncthreads();
    cur ^= 1;
  }

  // Write the core back.
  const T* src = var_base + cur * plane;
  for (int idx = threadIdx.x; idx < a.tile_h * a.tile_w; idx += blockDim.x) {
    const int cr = idx / a.tile_w;
    const int cc = idx - cr * a.tile_w;
    const int gr = blockIdx.y * a.tile_h + cr;
    const int gc = blockIdx.x * a.tile_w + cc;
    if (gr < a.H && gc < a.W) {
      const int li = (cr + a.halo) * WW + cc + a.halo;
#pragma unroll
      for (int f = 0; f < NV; ++f)
        a.f.var_out[f][static_cast<long>(gr) * a.W + gc] = src[f * 2 * plane + li];
    }
  }
}

template <class Op>
int launch_tile_pass(void* const* var_in, void* const* var_out, void* const* inv, int H,
                     int W, int tile_h, int tile_w, int iters_per_pass, int i_start,
                     int offset, int n_iterations, const double* params,
                     const double* halo, void* stream) {
  TilePassArgs<Op> a;
  a.f = make_fields<Op>(var_in, var_out, inv, halo);
  a.H = H;
  a.W = W;
  a.tile_h = tile_h;
  a.tile_w = tile_w;
  a.halo = Op::kRadius * iters_per_pass * Op::kSubiterations;
  a.steps = iters_per_pass * Op::kSubiterations;
  a.i_start = i_start;
  a.i_end = offset + n_iterations;
  const size_t smem = cell_smem_bytes<Op>() * static_cast<size_t>(tile_h + 2 * a.halo) *
                      static_cast<size_t>(tile_w + 2 * a.halo);
  cudaError_t e = cudaFuncSetAttribute(tile_pass_kernel<Op>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((W + tile_w - 1) / tile_w, (H + tile_h - 1) / tile_h);
  tile_pass_kernel<Op><<<grid, kTileThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, Op::from_params(params));
  return static_cast<int>(cudaGetLastError());
}

// Shape of a functor, for the Python wrapper's checks: {radius,
// n_subiterations, n_variant, n_invariant, n_params, element bytes,
// element is floating point}.
template <class Op>
int op_info(int* info) {
  info[0] = Op::kRadius;
  info[1] = Op::kSubiterations;
  info[2] = Op::kVariant;
  info[3] = Op::kInvariant;
  info[4] = Op::kParams;
  info[5] = static_cast<int>(sizeof(typename Op::T));
  info[6] = std::is_floating_point<typename Op::T>::value ? 1 : 0;
  return 0;
}

}  // namespace ss

#define SS_TILE_PASS_ENTRY(name, Op)                                                    \
  extern "C" int ss_tile_pass_##name(void* const* var_in, void* const* var_out,        \
                                     void* const* inv, int H, int W, int tile_h,        \
                                     int tile_w, int iters_per_pass, int i_start,       \
                                     int offset, int n_iterations, const double* params, \
                                     const double* halo, void* stream) {                \
    return ss::launch_tile_pass<Op>(var_in, var_out, inv, H, W, tile_h, tile_w,         \
                                    iters_per_pass, i_start, offset, n_iterations,      \
                                    params, halo, stream);                              \
  }                                                                                     \
  extern "C" int ss_op_info_##name(int* info) { return ss::op_info<Op>(info); }

SS_FOR_EACH_OP(SS_TILE_PASS_ENTRY)

extern "C" const char* ss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
