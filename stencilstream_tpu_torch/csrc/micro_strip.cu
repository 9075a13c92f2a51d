// The strip microbenchmarks' kernel: p fused Jacobi5-style sub-steps on
// windows of full-width rows, one window per strip of T rows.
//
// Replaces the TPU kernels of experiments/micro_shifts.py (make_kernel and
// the pallas_call in run.one_pass), experiments/micro_operands.py and
// experiments/micro_order.py (theirs likewise). The wrapper and the plain
// PyTorch version are stencilstream_tpu_torch/experiments/strip.py, whose
// docstring says what a pass computes; the variants below are its VARIANTS,
// in the same order (a variant's id is its position).
//
// Bound: bytes. A pass must read and write the grid once, 8 B a cell
// (0.160 ms at 8192^2 on an H100 SXM at 3.35 TB/s), against ~9 float32
// operations a cell and sub-step on the windows (0.081 ms at p=8).
//
// Design. A full-width window does not fit in shared memory (144 x 8192 x
// 4 B = 4.7 MB at T=128), so a CTA takes one 2D tile of one window's core
// (kTileRows x kTileCols), stages it with p cells of halo on each side,
// runs the p sub-steps ping-pong in shared memory on a region that narrows
// by one cell a side per sub-step (two per composite trip), and writes the
// core. Coordinates are the window's rows and the grid's columns: an axis
// that wraps maps a staged coordinate modulo the window's rows or the
// grid's width, which is exact because a torus is translation invariant;
// an axis that does not holds the halo value in every cell outside it, at
// every sub-step. The TPU kernels' knobs become Hopper knobs of the same
// values: masks recomputed per sub-step (inline) or computed once a CTA
// (hoisted) or a frame of halo cells written once and never recomputed
// (concat); coefficients, halo value and extra scalars as kernel arguments
// or literals (micro_operands' SMEM operands); the core written through a
// row pointer (elemout) or a 2D index. Each sub-step sums its taps in the
// variant's order and fuses exactly the multiply-adds the plain version
// fuses (Fuse: bit k for term k; the build uses -fmad=false). A simple
// kernel: one cell a thread at a time, no staging pipeline.

#include <cuda_runtime.h>

namespace ss_micro {

constexpr int kTileRows = 32;  // core rows of a CTA's tile
constexpr int kTileCols = 64;  // core columns of a CTA's tile
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;

enum Update { kShifts, kCenterFirst, kCenterLast, kComposite, kFma, kShiftOnly };
enum Out { kEdges, kShrink, kMiddle };
enum Mask { kNone, kFrame, kHoisted, kInline };

// micro_operands' SMEM operands: coefficients c0..c4 (north, west, south,
// east, centre), the halo value, ten extra scalars.
struct Scalars {
  float c[5];
  float hv;
  float extra[10];
};

struct Args {
  const float* x;
  float* out;
  int H, W, T, hp, n_strips, win;
  Scalars s;
};

template <bool RowsWrap, bool ColsWrap, int Upd, unsigned Fuse, int Out_, int Mask_, bool CoefArgs,
          bool HvArg, int NExtra, bool RowPointer>
struct Variant {
  static constexpr bool kRowsWrap = RowsWrap;
  static constexpr bool kColsWrap = ColsWrap;
  static constexpr int kUpdate = Upd;
  static constexpr unsigned kFuse = Fuse;
  static constexpr int kOut = Out_;
  static constexpr int kMask = Mask_;
  static constexpr bool kCoefArgs = CoefArgs;
  static constexpr bool kHvArg = HvArg;
  static constexpr int kNExtra = NExtra;
  static constexpr bool kRowPointer = RowPointer;
};

// The five coefficients as literals: micro_shifts' (W0, WN, WS, WW, WE) and
// micro_operands' and micro_order's (c0..c4) are the same numbers.
__host__ __device__ constexpr float coef_literal(int k) {
  return k == 0 ? 0x1.333334p-3f : k == 1 ? 0x1.99999ap-3f : k == 2 ? 0x1.0p-2f : k == 3 ? 0x1.99999ap-4f
                                                                                         : 0x1.333334p-2f;
}

// micro_shifts' composite two-step stencil (strip.COMPOSITE_TERMS): offset
// and float32 weight of term q, in the order its loop sums them.
__host__ __device__ constexpr int composite_dy(int q) {
  return q == 0 ? -2 : q < 4 ? -1 : q < 9 ? 0 : q < 12 ? 1 : 2;
}
__host__ __device__ constexpr int composite_dx(int q) {
  return q == 0 || q == 2 || q == 6 || q == 10 || q == 12 ? 0
         : q == 1 || q == 5 || q == 9                      ? -1
         : q == 3 || q == 7 || q == 11                     ? 1
         : q == 4                                          ? -2
                                                           : 2;
}
__host__ __device__ constexpr float composite_weight(int q) {
  return q == 0 || q == 1 ? 0x1.47ae14p-5f
         : q == 2         ? 0x1.eb851ep-5f
         : q == 3         ? 0x1.eb851ep-4f
         : q == 4         ? 0x1.47ae14p-7f
         : q == 5         ? 0x1.eb851ep-6f
         : q == 6         ? 0x1.75c290p-3f
         : q == 7 || q == 8 ? 0x1.70a3d8p-4f
         : q == 9         ? 0x1.99999ap-5f
         : q == 10        ? 0x1.333334p-4f
         : q == 11        ? 0x1.333334p-3f
                          : 0x1.0p-4f;
}

// micro_shifts' fma variant: x = a_j * x + b_j, j = 0..4; its shiftonly
// variant's weight 0.249.
__host__ __device__ constexpr float fma_scale(int j) {
  return j == 0 ? 0x1.ffd8aep-1f : j == 1 ? 0x1.ffe5cap-1f : j == 2 ? 0x1.fff2e4p-1f : j == 3 ? 1.0f
                                                                                           : 0x1.00068ep+0f;
}
__host__ __device__ constexpr float fma_shift(int j) {
  return j == 0 ? 0x1.ad7f2ap-24f : j == 1 ? 0x1.ad7f2ap-23f : j == 2 ? 0x1.421f60p-22f
         : j == 3                          ? 0x1.ad7f2ap-22f
                                           : 0x1.0c6f7ap-21f;
}
constexpr float kShiftOnlyWeight = 0x1.fdf3b6p-3f;

// sum(c[k] * t[k]) left to right: the first addition fuses term 0's product
// (Fuse bit 0), else term 1's (bit 1); each later one its own (bit k).
template <unsigned Fuse, int N>
__device__ __forceinline__ float fused_sum(const float (&t)[N], const float (&c)[N]) {
  float acc;
  if constexpr ((Fuse & 1u) != 0)
    acc = __fmaf_rn(t[0], c[0], t[1] * c[1]);
  else if constexpr ((Fuse & 2u) != 0)
    acc = __fmaf_rn(t[1], c[1], t[0] * c[0]);
  else
    acc = t[0] * c[0] + t[1] * c[1];
#pragma unroll
  for (int k = 2; k < N; ++k) acc = ((Fuse >> k) & 1u) ? __fmaf_rn(t[k], c[k], acc) : acc + t[k] * c[k];
  return acc;
}

template <class V>
__device__ __forceinline__ float coef(const Args& a, int k) {
  if constexpr (V::kCoefArgs)
    return a.s.c[k];
  else
    return coef_literal(k);
}

// One sub-step (one two-step trip for the composite) at shared cell i.
template <class V>
__device__ __forceinline__ float update(const float* src, int i, int pitch, const Args& a) {
  if constexpr (V::kUpdate == kFma) {
    float y = src[i];
#pragma unroll
    for (int j = 0; j < 5; ++j) y = __fmaf_rn(y, fma_scale(j), fma_shift(j));
    return y;
  } else if constexpr (V::kUpdate == kShiftOnly) {
    return (((src[i - pitch] + src[i + pitch]) + src[i - 1]) + src[i + 1]) * kShiftOnlyWeight;
  } else if constexpr (V::kUpdate == kComposite) {
    float t[13], c[13];
#pragma unroll
    for (int q = 0; q < 13; ++q) {
      t[q] = src[i + composite_dy(q) * pitch + composite_dx(q)];
      c[q] = composite_weight(q);
    }
    return fused_sum<V::kFuse>(t, c);
  } else {
    const float x = src[i], n = src[i - pitch], s = src[i + pitch], w = src[i - 1], e = src[i + 1];
    const float c0 = coef<V>(a, 0), c1 = coef<V>(a, 1), c2 = coef<V>(a, 2), c3 = coef<V>(a, 3),
                c4 = coef<V>(a, 4);
    float v;
    if constexpr (V::kUpdate == kShifts) {
      const float t[5] = {x, n, s, w, e}, c[5] = {c0, c1, c2, c3, c4};
      v = fused_sum<V::kFuse>(t, c);
    } else if constexpr (V::kUpdate == kCenterFirst) {
      const float t[5] = {x, n, w, s, e}, c[5] = {c4, c0, c1, c2, c3};
      v = fused_sum<V::kFuse>(t, c);
    } else {
      const float t[5] = {n, w, s, e, x}, c[5] = {c0, c1, c2, c3, c4};
      v = fused_sum<V::kFuse>(t, c);
    }
    if constexpr (V::kNExtra > 0) {
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < V::kNExtra; ++j) sum = sum + a.s.extra[j];
      v = v + 0.0f * sum;
    }
    return v;
  }
}

template <int P, class V>
struct Tile {
  static constexpr int kRadius = V::kUpdate == kComposite ? 2 : 1;
  static constexpr int kTrips = V::kUpdate == kComposite ? P / 2 : P;
  static constexpr int kRows = kTileRows + 2 * P;  // staged rows
  static constexpr int kCols = kTileCols + 2 * P;  // staged columns (the pitch)
  static constexpr size_t kSmem = 2 * sizeof(float) * kRows * kCols + kRows + kCols;
};

template <int P, class V>
__global__ void __launch_bounds__(kThreadsX * kThreadsY) micro_strip_kernel(Args a) {
  using G = Tile<P, V>;
  constexpr int SH = G::kRows, SW = G::kCols;
  extern __shared__ float smem[];
  float* src = smem;
  float* dst = smem + SH * SW;
  unsigned char* row_in = reinterpret_cast<unsigned char*>(smem + 2 * SH * SW);
  unsigned char* col_in = row_in + SH;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int strip = blockIdx.z;
  const int org = min(max(strip * a.T - a.hp, 0), a.H - a.win);
  int off;
  if constexpr (V::kOut == kShrink)
    off = P;
  else if constexpr (V::kOut == kMiddle)
    off = a.hp;
  else
    off = strip == 0 ? 0 : strip == a.n_strips - 1 ? 2 * a.hp : a.hp;
  const int r0 = off + blockIdx.y * kTileRows - P;  // window row of staged row 0
  const int c0 = blockIdx.x * kTileCols - P;        // grid column of staged column 0
  const float hv = V::kHvArg ? a.s.hv : 0.0f;

  // Stage the tile and its halo; cells outside an axis that does not wrap
  // hold the halo value, in both planes.
  for (int r = ty; r < SH; r += kThreadsY) {
    int wr = r0 + r;
    bool rin = true;
    if constexpr (V::kRowsWrap)
      wr = ((wr % a.win) + a.win) % a.win;
    else
      rin = wr >= 0 && wr < a.win;
    const float* xrow = a.x + static_cast<size_t>(org + (rin ? wr : 0)) * a.W;
    for (int c = tx; c < SW; c += kThreadsX) {
      int gc = c0 + c;
      bool cin = true;
      if constexpr (V::kColsWrap)
        gc = ((gc % a.W) + a.W) % a.W;
      else
        cin = gc >= 0 && gc < a.W;
      const float v = rin && cin ? __ldg(xrow + gc) : hv;
      src[r * SW + c] = v;
      dst[r * SW + c] = v;
    }
  }
  if constexpr (V::kMask == kHoisted) {
    for (int r = tx + kThreadsX * ty; r < SH; r += kThreadsX * kThreadsY)
      row_in[r] = V::kRowsWrap || (r0 + r >= 0 && r0 + r < a.win);
    for (int c = tx + kThreadsX * ty; c < SW; c += kThreadsX * kThreadsY)
      col_in[c] = V::kColsWrap || (c0 + c >= 0 && c0 + c < a.W);
  }
  // The frame variant computes only cells inside both axes.
  int r_lo = 0, r_hi = SH, c_lo = 0, c_hi = SW;
  if constexpr (V::kMask == kFrame) {
    if (!V::kRowsWrap) r_lo = max(0, -r0), r_hi = min(SH, a.win - r0);
    if (!V::kColsWrap) c_lo = max(0, -c0), c_hi = min(SW, a.W - c0);
  }

  for (int t = 0; t < G::kTrips; ++t) {
    __syncthreads();
    const int lo = (t + 1) * G::kRadius;
    const int rb = max(lo, r_lo), re = min(SH - lo, r_hi);
    const int cb = max(lo, c_lo), ce = min(SW - lo, c_hi);
    for (int r = rb + ty; r < re; r += kThreadsY) {
      for (int c = cb + tx; c < ce; c += kThreadsX) {
        float v = update<V>(src, r * SW + c, SW, a);
        if constexpr (V::kMask == kHoisted) {
          v = row_in[r] && col_in[c] ? v : hv;
        } else if constexpr (V::kMask == kInline) {
          const bool in = (V::kRowsWrap || (r0 + r >= 0 && r0 + r < a.win)) &&
                          (V::kColsWrap || (c0 + c >= 0 && c0 + c < a.W));
          v = in ? v : hv;
        }
        dst[r * SW + c] = v;
      }
    }
    float* tmp = src;
    src = dst;
    dst = tmp;
  }
  __syncthreads();

  // The core: window rows [off, off + T) of this tile, grid columns < W.
  for (int r = P + ty; r < P + kTileRows; r += kThreadsY) {
    const int k = blockIdx.y * kTileRows + (r - P);  // row within the strip
    if (k >= a.T) break;
    const int grow = strip * a.T + k;
    float* orow = a.out + static_cast<size_t>(grow) * a.W;
    for (int c = P + tx; c < P + kTileCols; c += kThreadsX) {
      const int gc = c0 + c;
      if (gc >= a.W) break;
      if constexpr (V::kRowPointer)
        orow[gc] = src[r * SW + c];
      else
        a.out[static_cast<size_t>(grow) * a.W + gc] = src[r * SW + c];
    }
  }
}

template <int P, class V>
int launch(const Args& a, cudaStream_t stream) {
  using G = Tile<P, V>;
  cudaError_t e = cudaFuncSetAttribute(micro_strip_kernel<P, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(G::kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.W + kTileCols - 1) / kTileCols, (a.T + kTileRows - 1) / kTileRows, a.n_strips);
  micro_strip_kernel<P, V><<<grid, dim3(kThreadsX, kThreadsY), G::kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <class V, bool P16>
int dispatch(int p, const Args& a, cudaStream_t stream) {
  if (p == 8) return launch<8, V>(a, stream);
  if constexpr (P16)
    if (p == 16) return launch<16, V>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace ss_micro

// The variants, in strip.VARIANTS' order:
// X(id, name, built at p=16 too, rows wrap, columns wrap, update, Fuse,
//   out, mask, coefficients as arguments, halo value as argument, extra
//   scalars, row pointer)
#define SS_MICRO_STRIP_VARIANTS(X)                                                                  \
  X(0, wrap, true, true, true, kShifts, 0x1f, kEdges, kNone, false, false, 0, false)               \
  X(1, hoisted, true, false, false, kShifts, 0x1, kEdges, kHoisted, false, false, 0, false)        \
  X(2, inline, true, false, false, kShifts, 0x1, kEdges, kInline, false, false, 0, false)          \
  X(3, concat, true, false, false, kShifts, 0x1f, kEdges, kFrame, false, false, 0, false)          \
  X(4, nomaskrow, true, true, false, kShifts, 0x7, kEdges, kInline, false, false, 0, false)        \
  X(5, composite, true, true, false, kComposite, 0x1445, kEdges, kInline, false, false, 0, false)  \
  X(6, fma, true, true, true, kFma, 0x0, kEdges, kNone, false, false, 0, false)                    \
  X(7, shiftonly, true, true, true, kShiftOnly, 0x0, kEdges, kNone, false, false, 0, false)        \
  X(8, shrink, true, false, false, kShifts, 0x7, kShrink, kInline, false, false, 0, false)         \
  X(9, baseline, false, false, false, kCenterFirst, 0x1, kEdges, kInline, false, false, 0, false)  \
  X(10, smem10, false, false, false, kCenterFirst, 0x1, kEdges, kInline, false, false, 10, false)  \
  X(11, coef, false, false, false, kCenterFirst, 0x1, kEdges, kInline, true, false, 0, false)      \
  X(12, hv, false, false, false, kCenterFirst, 0x1, kEdges, kInline, false, true, 0, false)        \
  X(13, elemout, false, false, false, kCenterFirst, 0x1, kEdges, kInline, false, false, 0, true)   \
  X(14, nowhere, false, false, false, kCenterFirst, 0x1, kMiddle, kInline, false, false, 0, false) \
  X(15, all, false, false, false, kCenterFirst, 0x1, kEdges, kInline, true, true, 10, true)        \
  X(16, centerfirst, false, false, false, kCenterFirst, 0x1, kEdges, kInline, false, false, 0, false) \
  X(17, centerlast, false, false, false, kCenterLast, 0x10, kEdges, kInline, false, false, 0, false)  \
  X(18, inter_cf, false, false, false, kCenterFirst, 0x1, kEdges, kInline, false, false, 0, false)    \
  X(19, grouped_nwse, false, false, false, kCenterLast, 0x10, kEdges, kInline, false, false, 0, false)

#define SS_MICRO_STRIP_CASE(id, name, p16, rw, cw, upd, fuse, out, mask, ca, ha, ne, rp) \
  case id:                                                                                \
    return ss_micro::dispatch<ss_micro::Variant<rw, cw, ss_micro::upd, fuse, ss_micro::out, \
                                                ss_micro::mask, ca, ha, ne, rp>,            \
                              p16>(p, a, static_cast<cudaStream_t>(stream));

// One pass of variant `variant` at p over the H x W float32 grid x into out
// (no overlap); strips of T rows, windows of T + 2*hp rows (H % T == 0 and
// H >= T + 2*hp, checked by the wrapper). `scalars`: host array of 16
// floats, micro_operands' c0..c4, halo value and ten extras. Returns the
// CUDA error of the launch.
extern "C" int ss_micro_strip(int variant, int p, const void* x, void* out, int H, int W, int T, int hp,
                              const float* scalars, void* stream) {
  ss_micro::Args a;
  a.x = static_cast<const float*>(x);
  a.out = static_cast<float*>(out);
  a.H = H;
  a.W = W;
  a.T = T;
  a.hp = hp;
  a.n_strips = H / T;
  a.win = T + 2 * hp;
  for (int k = 0; k < 5; ++k) a.s.c[k] = scalars[k];
  a.s.hv = scalars[5];
  for (int k = 0; k < 10; ++k) a.s.extra[k] = scalars[6 + k];
  if (T < 1 || H % T != 0 || H < a.win || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (variant) { SS_MICRO_STRIP_VARIANTS(SS_MICRO_STRIP_CASE) }
  return static_cast<int>(cudaErrorInvalidValue);
}
