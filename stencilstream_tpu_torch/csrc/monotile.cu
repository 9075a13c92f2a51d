// Resident-grid kernel: the whole grid lives in the CTAs' shared memory and
// all n iterations of a call run in one cooperative launch.
//
// Replaces the TPU kernel stencilstream_tpu/backends/monotile.py:_run_monotile
// (inner `kernel`, pallas_call at :253), which keeps the whole grid in VMEM
// and loops over every iteration inside one kernel.
//
// Each CTA owns a band of `band` full-width rows and keeps, in shared memory,
// its variant fields (two ping-pong planes) and its invariant fields (staged
// once), each with r halo rows above and below and r halo columns left and
// right. Every sub-step after the first, a CTA publishes its top and bottom r
// rows into a global exchange buffer (double-buffered by step parity), waits
// at a grid-wide barrier, pulls its neighbours' rows into its halo rows, and
// computes its band.
//
// What bounds it on Hopper: the grid never leaves the chip, so device memory
// is touched once per call (load and store) plus 2*r rows per CTA and
// sub-step of exchange through L2. Per cell-step the work is the same ~28 B
// of shared-memory traffic and ~10 flops as the tile pass, with no redundant
// halo ring. At 1024^2 a sub-step is ~8K cells per CTA, a few hundred
// cycles of work, so the grid barrier and the exchange's L2 round trip
// (about a microsecond or two per sub-step) bound it rather than arithmetic.
// The design pays one barrier per sub-step and nothing more: exchange parity
// lets a CTA publish step s+1 while a slow neighbour still reads step s.
//
// Every CTA must be resident at once (grid.sync()); the launcher checks the
// occupancy and launches cooperatively, which refuses a grid that is not.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "ops/all.cuh"

namespace cg = cooperative_groups;

namespace ss {

constexpr int kMonoThreads = 1024;

template <class Op>
struct MonotileArgs {
  using T = typename Op::T;
  Fields<Op> f;
  T* xchg;           // [parity 2][cta][side 2][variant field][r rows][W]
  int H, W;          // logical grid extent
  int band;          // rows per CTA (>= r)
  int offset;        // absolute iteration of the first step
  int n_iterations;
};

template <class Op>
__global__ void __launch_bounds__(kMonoThreads, 1)
monotile_kernel(const MonotileArgs<Op> a, const Op op) {
  using T = typename Op::T;
  constexpr int NV = Op::kVariant;
  constexpr int NI = Op::kInvariant;
  constexpr int R = Op::kRadius;
  constexpr int K = Op::kSubiterations;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* var_base = reinterpret_cast<T*>(smem_raw);
  cg::grid_group grid = cg::this_grid();

  const int pitch = a.W + 2 * R;
  const int plane = (a.band + 2 * R) * pitch;
  T* inv_base = var_base + 2 * NV * plane;
  const int b = blockIdx.x;
  const int g0 = b * a.band - R;  // global row of shared row 0
  const int grows = min(a.band, a.H - b * a.band);  // in-grid rows of the band

  // Load the band with its halo rows and columns into both ping-pong planes;
  // cells outside the grid hold the halo value and are never computed.
  for (int idx = threadIdx.x; idx < plane; idx += blockDim.x) {
    const int sr = idx / pitch;
    const int sc = idx - sr * pitch;
    const int gr = g0 + sr;
    const int gc = sc - R;
    const bool in = gr >= 0 && gr < a.H && gc >= 0 && gc < a.W;
    const long gi = static_cast<long>(gr) * a.W + gc;
#pragma unroll
    for (int f = 0; f < NV; ++f) {
      const T v = in ? a.f.var_in[f][gi] : a.f.halo_var[f];
      var_base[f * 2 * plane + idx] = v;
      var_base[f * 2 * plane + plane + idx] = v;
    }
#pragma unroll
    for (int f = 0; f < NI; ++f)
      inv_base[f * plane + idx] = in ? a.f.inv[f][gi] : a.f.halo_inv[f];
  }
  __syncthreads();

  const int side = NV * R * a.W;                   // one side of one CTA
  const long parity_elems = 2L * gridDim.x * side;  // all CTAs, both sides
  const int steps = a.n_iterations * K;
  int cur = 0;
  for (int s = 0; s < steps; ++s) {
    T* src = var_base + cur * plane;
    if (s > 0) {
      // Publish this band's top and bottom R rows (computed last sub-step).
      T* x = a.xchg + (s & 1) * parity_elems;
      T* mine = x + 2L * b * side;
      for (int idx = threadIdx.x; idx < side; idx += blockDim.x) {
        const int f = idx / (R * a.W);
        const int rem = idx - f * R * a.W;
        const int j = rem / a.W;
        const int c = rem - j * a.W;
        const T* fp = src + f * 2 * plane + R + c;
        __stcg(mine + idx, fp[(R + j) * pitch]);             // band rows 0..R-1
        __stcg(mine + side + idx, fp[(a.band + j) * pitch]);  // band rows band-R..band-1
      }
      grid.sync();
      // Pull the neighbours' rows into this band's halo rows.
      for (int idx = threadIdx.x; idx < side; idx += blockDim.x) {
        const int f = idx / (R * a.W);
        const int rem = idx - f * R * a.W;
        const int j = rem / a.W;
        const int c = rem - j * a.W;
        T* fp = src + f * 2 * plane + R + c;
        // Shared row j is global row g0 + j: the bottom side of CTA b-1.
        fp[j * pitch] = g0 + j < 0 ? a.f.halo_var[f]
                                   : __ldcg(x + 2L * (b - 1) * side + side + idx);
        // Shared row band+R+j is global row (b+1)*band + j: the top side of CTA b+1.
        fp[(a.band + R + j) * pitch] = (b + 1) * a.band + j >= a.H
                                           ? a.f.halo_var[f]
                                           : __ldcg(x + 2L * (b + 1) * side + idx);
      }
      __syncthreads();
    }
    const int iteration = a.offset + s / K;
    const int sub = s % K;
    T* dst = var_base + (cur ^ 1) * plane;
    for (int idx = threadIdx.x; idx < grows * a.W; idx += blockDim.x) {
      const int br = idx / a.W;
      const int c = idx - br * a.W;
      const int li = (br + R) * pitch + c + R;
      const Taps<T> t{src + li, inv_base + li, 2L * plane, static_cast<long>(plane),
                      pitch, b * a.band + br, c, a.H, a.W, iteration, sub};
      T out[NV];
      op(t, out);
#pragma unroll
      for (int f = 0; f < NV; ++f) dst[f * 2 * plane + li] = out[f];
    }
    __syncthreads();
    cur ^= 1;
  }

  // Store the band.
  const T* src = var_base + cur * plane;
  for (int idx = threadIdx.x; idx < grows * a.W; idx += blockDim.x) {
    const int br = idx / a.W;
    const int c = idx - br * a.W;
    const int li = (br + R) * pitch + c + R;
    const long gi = static_cast<long>(b * a.band + br) * a.W + c;
#pragma unroll
    for (int f = 0; f < NV; ++f) a.f.var_out[f][gi] = src[f * 2 * plane + li];
  }
}

template <class Op>
int launch_monotile(void* const* var_in, void* const* var_out, void* const* inv, int H, int W,
                    int band, int n_ctas, int offset, int n_iterations, const double* params,
                    const double* halo, void* xchg, void* stream) {
  MonotileArgs<Op> a;
  a.f = make_fields<Op>(var_in, var_out, inv, halo);
  a.xchg = static_cast<typename Op::T*>(xchg);
  a.H = H;
  a.W = W;
  a.band = band;
  a.offset = offset;
  a.n_iterations = n_iterations;
  Op op = Op::from_params(params);
  const size_t smem = cell_smem_bytes<Op>() * static_cast<size_t>(band + 2 * Op::kRadius) *
                      static_cast<size_t>(W + 2 * Op::kRadius);
  cudaError_t e = cudaFuncSetAttribute(monotile_kernel<Op>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, monotile_kernel<Op>,
                                                         kMonoThreads, smem)) != cudaSuccess)
    return static_cast<int>(e);
  if (per_sm * sms < n_ctas) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&a, &op};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(monotile_kernel<Op>),
                                  dim3(n_ctas), dim3(kMonoThreads), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ss

#define SS_MONOTILE_ENTRY(name, Op)                                                       \
  extern "C" int ss_monotile_##name(void* const* var_in, void* const* var_out,           \
                                    void* const* inv, int H, int W, int band, int n_ctas, \
                                    int offset, int n_iterations, const double* params,   \
                                    const double* halo, void* xchg, void* stream) {       \
    return ss::launch_monotile<Op>(var_in, var_out, inv, H, W, band, n_ctas, offset,      \
                                   n_iterations, params, halo, xchg, stream);             \
  }

SS_FOR_EACH_OP(SS_MONOTILE_ENTRY)
