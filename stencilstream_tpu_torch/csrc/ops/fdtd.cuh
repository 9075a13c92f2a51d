// FDTD device functors: the C++ twins of
// stencilstream_tpu_torch/models/fdtd/kernel.py:FDTDKernel, one for each
// material resolver (models/fdtd/materials.py).
//
// A 2D TM-mode Yee update, radius 1, two sub-steps per iteration: sub-step 0
// updates the electric field (ex, ey) from hz, sub-step 1 the magnetic field
// hz from ex and ey, adds the source wave to the cells of the source disk up
// to the cutoff iteration, and after the detect iteration accumulates hz^2
// into hz_sum. Variant fields: ex, ey, hz, hz_sum. The source amplitude is
// the time-dependent value (float), one per iteration, read from the call's
// stream; no kernel evaluates it.
//
// The update keeps the Python twin's association term by term and the
// multiply-adds that XLA fuses in the JAX package's kernel:
//   ex = fma(ex, ca, cb * (hz - hz[0,-1])),  ey = fma(ey, ca, cb * (hz[-1,0] - hz)),
//   hz = fma(hz, da, db * (((ex[0,1] - ex) + ey) - ey[1,0])),
//   disk source: interp = fma(-d2, 1 / source_radius^2, 1), then an unfused
//   hz + interp * amplitude,
//   hz_sum = fma(hz, hz, hz_sum);
// the kernels are built without any other FMA contraction, so the two round
// alike.
//
// Runtime parameters, in order (FDTDKernel.cuda_params()): cutoff
// iteration, detect iteration, source row, source column, the source
// distance bound, the source radius squared (0: a point source), its float32
// reciprocal, twice the grid centre; then the resolver's:
//   coef    none: ca, cb, da, db are invariant fields of the cell;
//   lut     the 16-entry coefficient table, ca[16] cb[16] da[16] db[16]: the
//           cell's invariant int32 ring index (read as the bits of a float
//           plane, which the kernels only copy) picks the entry, 0 outside
//           [0, 16);
//   render  the same table and 16 distance bounds: the first ring whose bound
//           covers the cell's distance score picks the entry.
// The tables travel by value in the functor, like every other parameter.
#pragma once

#include "../common.cuh"

namespace ss {

constexpr int kFdtdRings = 16;     // models/fdtd/params.py: MAX_N_RINGS + 1
constexpr int kFdtdCommonParams = 8;

// Coefficients stored in every cell: invariant fields ca, cb, da, db.
struct FdtdCoefMaterial {
  static constexpr int kInvariant = 4;
  static constexpr int kTableParams = 0;
  void read(const double*) {}
  // (ca, cb) for sub-step 0, (da, db) for sub-step 1.
  __device__ __forceinline__ void coefficients(const Taps<float, float>& s, float, float& a,
                                               float& b) const {
    const int j = s.subiteration == 0 ? 0 : 2;
    a = s.i(j, 0, 0);
    b = s.i(j + 1, 0, 0);
  }
};

// The coefficient table of the LUT and render resolvers.
struct FdtdTable {
  float table[4][kFdtdRings];  // ca, cb, da, db
  void read_table(const double* p) {
    for (int f = 0; f < 4; ++f)
      for (int j = 0; j < kFdtdRings; ++j) table[f][j] = static_cast<float>(p[f * kFdtdRings + j]);
  }
};

// A ring index stored per cell, looked up in the table.
struct FdtdLutMaterial : FdtdTable {
  static constexpr int kInvariant = 1;
  static constexpr int kTableParams = 4 * kFdtdRings;
  void read(const double* p) { read_table(p); }
  __device__ __forceinline__ void coefficients(const Taps<float, float>& s, float, float& a,
                                               float& b) const {
    const int index = __float_as_int(s.i(0, 0, 0));
    const int f = s.subiteration == 0 ? 0 : 2;
    a = 0.0f;
    b = 0.0f;
#pragma unroll
    for (int j = 0; j < kFdtdRings; ++j) {
      if (index == j) {
        a = f == 0 ? table[0][j] : table[2][j];
        b = f == 0 ? table[1][j] : table[3][j];
      }
    }
  }
};

// The ring rendered from the cell's distance score: the innermost ring whose
// bound covers it (the table's last entry when none does).
struct FdtdRenderMaterial : FdtdTable {
  static constexpr int kInvariant = 0;
  static constexpr int kTableParams = 5 * kFdtdRings;
  float bounds[kFdtdRings];
  void read(const double* p) {
    read_table(p);
    for (int j = 0; j < kFdtdRings; ++j) bounds[j] = static_cast<float>(p[4 * kFdtdRings + j]);
  }
  __device__ __forceinline__ void coefficients(const Taps<float, float>& s, float score, float& a,
                                               float& b) const {
    const bool e = s.subiteration == 0;
    a = e ? table[0][kFdtdRings - 1] : table[2][kFdtdRings - 1];
    b = e ? table[1][kFdtdRings - 1] : table[3][kFdtdRings - 1];
#pragma unroll
    for (int j = kFdtdRings - 1; j >= 0; --j) {
      if (score <= bounds[j]) {
        a = e ? table[0][j] : table[2][j];
        b = e ? table[1][j] : table[3][j];
      }
    }
  }
};

template <class Material, class Self>
struct FdtdT {
  using T = float;
  using Tdv = float;
  static constexpr int kRadius = 1;
  static constexpr int kSubiterations = 2;
  static constexpr int kVariant = 4;
  static constexpr int kInvariant = Material::kInvariant;
  static constexpr int kParams = kFdtdCommonParams + Material::kTableParams;

  int cutoff_iteration, detect_iteration;
  float source_r, source_c, source_distance_bound;
  float source_radius_squared, inv_source_radius_squared, double_center_rc;
  Material material;

  static Self from_params(const double* p) {
    Self op{};
    op.cutoff_iteration = static_cast<int>(p[0]);
    op.detect_iteration = static_cast<int>(p[1]);
    op.source_r = static_cast<float>(p[2]);
    op.source_c = static_cast<float>(p[3]);
    op.source_distance_bound = static_cast<float>(p[4]);
    op.source_radius_squared = static_cast<float>(p[5]);
    op.inv_source_radius_squared = static_cast<float>(p[6]);
    op.double_center_rc = static_cast<float>(p[7]);
    op.material.read(p + kFdtdCommonParams);
    return op;
  }

  __device__ __forceinline__ void operator()(const Taps<float, float>& s, float* out) const {
    const float r = static_cast<float>(s.row);
    const float c = static_cast<float>(s.col);
    const float ex = s.v(0, 0, 0);
    const float ey = s.v(1, 0, 0);
    const float hz = s.v(2, 0, 0);
    const float hz_sum = s.v(3, 0, 0);
    // Distance scores: integer-valued, so exact in float32 on these grids.
    const float center_score = r * (r - double_center_rc) + c * (c - double_center_rc);
    float a, b;
    material.coefficients(s, center_score, a, b);
    if (s.subiteration == 0) {
      out[0] = __fmaf_rn(ex, a, b * (hz - s.v(2, 0, -1)));
      out[1] = __fmaf_rn(ey, a, b * (s.v(2, -1, 0) - hz));
      out[2] = hz;
      out[3] = hz_sum;
      return;
    }
    float h = __fmaf_rn(hz, a, b * (((s.v(0, 0, 1) - ex) + ey) - s.v(1, 1, 0)));
    const float source_score = r * (r - 2.0f * source_r) + c * (c - 2.0f * source_c);
    const bool in_source = source_score <= source_distance_bound && s.iteration <= cutoff_iteration;
    float interp = 1.0f;
    if (source_radius_squared != 0.0f) {
      const float d2 = source_score + source_c * source_c + source_r * source_r;
      interp = __fmaf_rn(-d2, inv_source_radius_squared, 1.0f);
    }
    h = h + (in_source ? interp * s.tdv : 0.0f);
    out[0] = ex;
    out[1] = ey;
    out[2] = h;
    out[3] = s.iteration > detect_iteration ? __fmaf_rn(h, h, hz_sum) : hz_sum;
  }
};

struct FdtdCoefOp : FdtdT<FdtdCoefMaterial, FdtdCoefOp> {};
struct FdtdLutOp : FdtdT<FdtdLutMaterial, FdtdLutOp> {};
struct FdtdRenderOp : FdtdT<FdtdRenderMaterial, FdtdRenderOp> {};

}  // namespace ss
