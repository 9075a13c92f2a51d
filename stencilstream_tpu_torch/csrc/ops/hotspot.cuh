// HotSpot (Rodinia) device functor: the C++ twin of
// stencilstream_tpu_torch/models/hotspot.py:HotspotKernel.
//
// Cell fields: temp (variant), power (invariant). Runtime parameters, in
// order: Rx_1, Ry_1, Rz_1, Cap_1 (HotspotKernel.cuda_params()). At a grid
// edge the missing neighbour is replaced by the centre temperature. The
// update keeps the Python twin's association term by term, including the
// four multiply-adds that XLA fuses, and the kernels are built without any
// other FMA contraction, so the two round alike.
#pragma once

#include "../common.cuh"

namespace ss {

struct HotspotOp {
  using T = float;
  static constexpr int kRadius = 1;
  static constexpr int kSubiterations = 1;
  static constexpr int kVariant = 1;
  static constexpr int kInvariant = 1;
  static constexpr int kParams = 4;
  static constexpr float kAmbTemp = 80.0f;  // models/hotspot.py:AMB_TEMP

  float Rx_1, Ry_1, Rz_1, Cap_1;

  static HotspotOp from_params(const double* p) {
    return HotspotOp{static_cast<float>(p[0]), static_cast<float>(p[1]),
                     static_cast<float>(p[2]), static_cast<float>(p[3])};
  }

  template <class Tp>
  __device__ __forceinline__ void operator()(const Tp& s, float* out) const {
    const float old = s.v(0, 0, 0);
    const float power = s.i(0, 0, 0);
    const float top = s.row == 0 ? old : s.v(0, -1, 0);
    const float bottom = s.row == s.H - 1 ? old : s.v(0, 1, 0);
    const float left = s.col == 0 ? old : s.v(0, 0, -1);
    const float right = s.col == s.W - 1 ? old : s.v(0, 0, 1);
    // Fused multiply-adds where XLA fuses the reference's.
    const float old_coef = __fmaf_rn(-Cap_1, 2.0f * Ry_1 + 2.0f * Rx_1 + Rz_1, 1.0f);
    float acc = power + kAmbTemp * Rz_1;
    acc = __fmaf_rn(bottom + top, Ry_1, acc);
    acc = __fmaf_rn(right + left, Rx_1, acc);
    out[0] = __fmaf_rn(old, old_coef, acc * Cap_1);
  }
};

}  // namespace ss
