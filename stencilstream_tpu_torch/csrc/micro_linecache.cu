// The line-cache microbenchmarks' kernel: Jacobi5 levels over skewed
// strips, each level's last two rows carried down, a zero carry at the top.
//
// Replaces the TPU kernels of experiments/micro_linecache.py
// (make_lc_kernel and the pallas_call in run_lc.one_pass) and
// experiments/lc_bisect.py (build's five scratch layouts). The wrapper and
// the plain PyTorch version are stencilstream_tpu_torch/experiments/
// linecache.py, whose docstring says what a pass computes; the variants
// below are its VARIANTS, in the same order (a variant's id is its
// position).
//
// Bound: bytes at p=16 (the grid read once and written once, 8 B a cell:
// 0.160 ms at 8192^2 on an H100 SXM at 3.35 TB/s) and operations at p=32
// (9 a cell and level: 0.288 ms at 67 TFLOP/s).
//
// Design: the structure of line_cache.cu with the TPU kernel's semantics.
// The TPU walked full-width strips in order; a CTA here walks one column
// panel (kPanel columns plus p columns of halo on each side, recomputed)
// top to bottom in chunks of R rows (R divides the strip, so a strip
// boundary falls on a chunk boundary), with each level's last two rows
// carried from one chunk to the next in shared memory. The result does not
// depend on the chunk: level s+1's row g reads level s's rows g-1, g, g+1,
// whichever chunk computed them. To give the card enough CTAs, each panel
// is cut into segments of kSegmentChunks chunks; a segment starts its walk
// ceil(2p / R) chunks early and writes nothing there: rows at or below the
// walk's first row plus 2p no longer depend on the carry it started with,
// so they come out bit for bit as in one walk from the top. Columns outside
// the grid hold 0 at every level. The TPU knobs become Hopper knobs of the
// same values: stitch (the carried rows copied above the chunk's rows in
// one window) or taps that read the carry for the top two rows; the carry
// as p x 2 rows (3d) or rows 8s and 8s+1 of 8p (2d); zeroed before the
// first strip, before every strip (noscratch), or never (*_noinit: strip
// 0's rows [0, 2p) undefined, as on the TPU); the output through (strip,
// row) indices (blocked) or a row pointer. The kernel does not write in
// place (the wrapper refuses out == x); it writes NaN into out's pad rows,
// which the TPU kernel never wrote. Sums: the centre's product, then one
// fused multiply-add a further tap in the script's order (jacobi5_general's
// rounding; the build uses -fmad=false). A simple kernel: no staging pipeline.

#include <cuda_runtime.h>

namespace ss_mlc {

constexpr int kPanel = 128;         // core columns of a panel
constexpr int kSegmentChunks = 16;  // chunks of output rows a CTA writes
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;

enum Order { kJacobi5, kBisect };
enum Carry { kFirst, kEvery, kNone };
enum Layout { k3d, k2d };

template <int Order_, int Carry_, int Layout_, bool Stitch, bool Blocked>
struct Variant {
  static constexpr int kOrder = Order_;
  static constexpr int kCarry = Carry_;
  static constexpr int kLayout = Layout_;
  static constexpr bool kStitch = Stitch;
  static constexpr bool kBlocked = Blocked;
};

struct Args {
  const float* x;
  float* out;
  int H, W, Ha, T, R, n_chunks;
};

template <int P>
struct Panel {
  static constexpr int kCols = kPanel + 2 * P;  // staged columns (the pitch)
};

// The carry's rows per level (2 in 3d, 8 in 2d).
template <class V>
__host__ __device__ constexpr int carry_stride() {
  return V::kLayout == k2d ? 8 : 2;
}

template <int P, class V>
size_t smem_bytes(int R) {
  return sizeof(float) * Panel<P>::kCols * (2 * (R + 2) + carry_stride<V>() * P);
}

// One level's Jacobi5 update: micro_linecache's (CN, WW_, WS, WE, W0) =
// (0.15, 0.2, 0.25, 0.1, 0.3) as W0*c, then north, west, south, east;
// lc_bisect's (W0, WN, WS, WW, WE) = (0.15, 0.2, 0.25, 0.1, 0.3) as W0*c,
// then north, south, west, east.
template <class V>
__device__ __forceinline__ float level_update(float c, float n, float s, float w, float e) {
  if constexpr (V::kOrder == kJacobi5) {
    float acc = c * 0x1.333334p-2f;
    acc = __fmaf_rn(n, 0x1.333334p-3f, acc);
    acc = __fmaf_rn(w, 0x1.99999ap-3f, acc);
    acc = __fmaf_rn(s, 0x1.0p-2f, acc);
    return __fmaf_rn(e, 0x1.99999ap-4f, acc);
  } else {
    float acc = c * 0x1.333334p-3f;
    acc = __fmaf_rn(n, 0x1.99999ap-3f, acc);
    acc = __fmaf_rn(s, 0x1.0p-2f, acc);
    acc = __fmaf_rn(w, 0x1.99999ap-4f, acc);
    return __fmaf_rn(e, 0x1.333334p-2f, acc);
  }
}

template <int P, class V>
__global__ void __launch_bounds__(kThreadsX * kThreadsY) micro_linecache_kernel(Args a) {
  constexpr int SW = Panel<P>::kCols;
  constexpr int CS = carry_stride<V>();
  extern __shared__ float smem[];
  const int R = a.R;
  float* plane[2] = {smem, smem + (R + 2) * SW};  // window rows: 2 carried, then R own
  float* carry = smem + 2 * (R + 2) * SW;         // level s: rows CS*s, CS*s + 1
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c0 = blockIdx.x * kPanel - P;  // grid column of staged column 0
  const int k0 = blockIdx.y * kSegmentChunks;
  const int k_end = min(k0 + kSegmentChunks, a.n_chunks);
  const int warm = (2 * P + R - 1) / R;
  const int kw = max(0, k0 - warm);

  for (int k = kw; k < k_end; ++k) {
    // The carry of every level: zero before the walk's first chunk and, for
    // noscratch, at each strip boundary; never for *_noinit.
    if (V::kCarry != kNone && (k == kw || (V::kCarry == kEvery && (k * R) % a.T == 0))) {
      for (int r = ty; r < CS * P; r += kThreadsY)
        for (int c = tx; c < SW; c += kThreadsX) carry[r * SW + c] = 0.0f;
    }
    // Level 0: x's rows [kR + p, kR + p + R), 0 outside the grid's columns.
    for (int r = ty; r < R; r += kThreadsY) {
      const float* xrow = a.x + static_cast<size_t>(k * R + P + r) * a.W;
      for (int c = tx; c < SW; c += kThreadsX) {
        const int gc = c0 + c;
        plane[0][(r + 2) * SW + c] = gc >= 0 && gc < a.W ? __ldg(xrow + gc) : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll 1
    for (int s = 0; s < P; ++s) {
      const float* cur = plane[s & 1];
      float* nxt = plane[(s + 1) & 1];
      float* cs = carry + CS * s * SW;
      if constexpr (V::kStitch) {
        // The carried rows above the chunk's, in one window.
        for (int r = ty; r < 2; r += kThreadsY)
          for (int c = tx; c < SW; c += kThreadsX) plane[s & 1][r * SW + c] = cs[r * SW + c];
        __syncthreads();
      }
      const int lo = s + 1, hi = SW - s - 1;
      for (int i = ty; i < R; i += kThreadsY) {
        // Window rows i (north), i + 1 (centre), i + 2 (south).
        const float* north = V::kStitch || i >= 2 ? cur + i * SW : cs + i * SW;
        const float* center = V::kStitch || i >= 1 ? cur + (i + 1) * SW : cs + SW;
        const float* south = cur + (i + 2) * SW;
        for (int c = lo + tx; c < hi; c += kThreadsX) {
          const int gc = c0 + c;
          const float v = level_update<V>(center[c], north[c], south[c], center[c - 1], center[c + 1]);
          nxt[(i + 2) * SW + c] = gc >= 0 && gc < a.W ? v : 0.0f;
        }
      }
      if constexpr (!V::kStitch) __syncthreads();  // the taps above read the carry
      // The next chunk's carry: this level's last two rows.
      for (int r = ty; r < 2; r += kThreadsY)
        for (int c = tx; c < SW; c += kThreadsX) cs[r * SW + c] = cur[(R + r) * SW + c];
      __syncthreads();
    }
    // Level p is the output's rows [kR, kR + R), written outside the warm-up.
    if (k >= k0) {
      const float* res = plane[P & 1];
      for (int r = ty; r < R; r += kThreadsY) {
        const int g = k * R + r;
        float* orow = a.out + static_cast<size_t>(g) * a.W;
        for (int c = P + tx; c < P + kPanel; c += kThreadsX) {
          const int gc = c0 + c;
          if (gc >= a.W) break;
          if constexpr (V::kBlocked)
            a.out[(static_cast<size_t>(g / a.T) * a.T + g % a.T) * a.W + gc] = res[(r + 2) * SW + c];
          else
            orow[gc] = res[(r + 2) * SW + c];
        }
      }
    }
    __syncthreads();
  }
  // The pad rows [H, Ha): NaN (the TPU kernel never wrote them).
  if (blockIdx.y == gridDim.y - 1) {
    for (int g = a.H + ty; g < a.Ha; g += kThreadsY)
      for (int c = P + tx; c < P + kPanel; c += kThreadsX) {
        const int gc = c0 + c;
        if (gc >= a.W) break;
        a.out[static_cast<size_t>(g) * a.W + gc] = __int_as_float(0x7fc00000);
      }
  }
}

template <int P, class V>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<P, V>(a.R);
  cudaError_t e = cudaFuncSetAttribute(micro_linecache_kernel<P, V>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.W + kPanel - 1) / kPanel, (a.n_chunks + kSegmentChunks - 1) / kSegmentChunks);
  micro_linecache_kernel<P, V><<<grid, dim3(kThreadsX, kThreadsY), smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <class V, bool AllP>
int dispatch(int p, const Args& a, cudaStream_t stream) {
  if (p == 8) return launch<8, V>(a, stream);
  if constexpr (AllP) {
    if (p == 16) return launch<16, V>(a, stream);
    if (p == 32) return launch<32, V>(a, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace ss_mlc

// The variants, in linecache.VARIANTS' order:
// X(id, name, built at p=16 and 32 too, order, carry, layout, stitch, blocked)
#define SS_MICRO_LINECACHE_VARIANTS(X)                  \
  X(0, lc, true, kJacobi5, kFirst, k3d, false, false)   \
  X(1, lcs, true, kJacobi5, kFirst, k3d, true, false)   \
  X(2, lcb, true, kJacobi5, kFirst, k3d, false, true)   \
  X(3, lcsb, true, kJacobi5, kFirst, k3d, true, true)   \
  X(4, noscratch, false, kBisect, kEvery, k3d, false, false) \
  X(5, scratch3d, false, kBisect, kFirst, k3d, false, false) \
  X(6, scratch3d_noinit, false, kBisect, kNone, k3d, false, false) \
  X(7, scratch2d, false, kBisect, kFirst, k2d, false, false) \
  X(8, scratch2d_noinit, false, kBisect, kNone, k2d, false, false)

#define SS_MICRO_LINECACHE_CASE(id, name, all_p, order, carry, layout, stitch, blocked)              \
  case id:                                                                                           \
    return ss_mlc::dispatch<                                                                         \
        ss_mlc::Variant<ss_mlc::order, ss_mlc::carry, ss_mlc::layout, stitch, blocked>, all_p>(      \
        p, a, static_cast<cudaStream_t>(stream));

// One pass of variant `variant` at p over x (Ha x W float32: H grid rows,
// then pad) into out (the same shape, no overlap); strips of T rows walked
// in chunks of R rows (R divides T; H % T == 0, Ha >= H + p, checked by the
// wrapper); out's pad rows are NaN. Returns the CUDA error of the launch.
extern "C" int ss_micro_linecache(int variant, int p, const void* x, void* out, int H, int W, int Ha, int T,
                                  int R, void* stream) {
  ss_mlc::Args a;
  a.x = static_cast<const float*>(x);
  a.out = static_cast<float*>(out);
  a.H = H;
  a.W = W;
  a.Ha = Ha;
  a.T = T;
  a.R = R;
  a.n_chunks = H / R;
  if (R < 2 || R > 32 || T % R != 0 || H % T != 0 || Ha < H + p || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (variant) { SS_MICRO_LINECACHE_VARIANTS(SS_MICRO_LINECACHE_CASE) }
  return static_cast<int>(cudaErrorInvalidValue);
}
