// Self-verifying probe device functors: the C++ twins of
// stencilstream_tpu_torch/probe.py's ProbeKernel (the probe without a
// time-dependent value) and ProbeTransFunc (the probe whose time-dependent
// value is the iteration index, at radius 1 or 2).
//
// Five int32 cell fields, all updated: r, c, i_iteration, i_subiteration,
// status; radius R, two sub-steps per iteration. Every neighbour inside the
// grid must carry its own coordinates, the current iteration and
// sub-iteration and Normal status; every neighbour outside the grid must
// equal the probe's halo cell (0, 0, 0, 0, Halo); a probe with a
// time-dependent value must see the iteration index there. A cell that sees
// anything else turns Invalid for good; a valid cell advances its counters.
#pragma once

#include "../common.cuh"

namespace ss {

template <int R, class D, class Self>
struct ProbeT {
  using T = int;
  using Tdv = D;
  static constexpr int kRadius = R;
  static constexpr int kSubiterations = 2;
  static constexpr int kVariant = 5;
  static constexpr int kInvariant = 0;
  static constexpr int kParams = 0;
  static constexpr int kNormal = 0;
  static constexpr int kInvalid = 1;
  static constexpr int kHalo = 2;

  static Self from_params(const double*) { return {}; }

  __device__ __forceinline__ void operator()(const Taps<int, D>& s, int* out) const {
    bool valid = true;
    if constexpr (!std::is_same<D, NoTdv>::value) valid = s.tdv == s.iteration;
#pragma unroll
    for (int dr = -R; dr <= R; ++dr) {
#pragma unroll
      for (int dc = -R; dc <= R; ++dc) {
        const int nr = s.row + dr;
        const int nc = s.col + dc;
        const bool in_grid = nr >= 0 && nc >= 0 && nr < s.H && nc < s.W;
        const int want[5] = {in_grid ? nr : 0, in_grid ? nc : 0, in_grid ? s.iteration : 0,
                             in_grid ? s.subiteration : 0, in_grid ? kNormal : kHalo};
#pragma unroll
        for (int f = 0; f < 5; ++f) valid &= s.v(f, dr, dc) == want[f];
      }
    }
    const bool last_sub = s.subiteration == kSubiterations - 1;
    out[0] = s.v(0, 0, 0);
    out[1] = s.v(1, 0, 0);
    out[2] = last_sub ? s.v(2, 0, 0) + 1 : s.v(2, 0, 0);
    out[3] = last_sub ? 0 : s.v(3, 0, 0) + 1;
    out[4] = valid ? kNormal : kInvalid;
  }
};

// probe.py:ProbeKernel: no time-dependent value, radius 1.
struct ProbeOp : ProbeT<1, NoTdv, ProbeOp> {};
// probe.py:ProbeTransFunc: an int32 time-dependent value, radius 1 or 2.
struct ProbeTdvOp : ProbeT<1, int, ProbeTdvOp> {};
struct ProbeRadius2Op : ProbeT<2, int, ProbeRadius2Op> {};

}  // namespace ss
