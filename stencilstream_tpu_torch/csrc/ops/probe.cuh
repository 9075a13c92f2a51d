// Self-verifying probe device functor: the C++ twin of
// stencilstream_tpu_torch/probe.py:ProbeKernel (the probe without a
// time-dependent value).
//
// Five int32 cell fields, all updated: r, c, i_iteration, i_subiteration,
// status; radius 1, two sub-steps per iteration. Every neighbour inside the
// grid must carry its own coordinates, the current iteration and
// sub-iteration and Normal status; every neighbour outside the grid must
// equal the probe's halo cell (0, 0, 0, 0, Halo). A cell that sees anything
// else turns Invalid for good; a valid cell advances its counters.
#pragma once

#include "../common.cuh"

namespace ss {

struct ProbeOp {
  using T = int;
  static constexpr int kRadius = 1;
  static constexpr int kSubiterations = 2;
  static constexpr int kVariant = 5;
  static constexpr int kInvariant = 0;
  static constexpr int kParams = 0;
  static constexpr int kNormal = 0;
  static constexpr int kInvalid = 1;
  static constexpr int kHalo = 2;

  static ProbeOp from_params(const double*) { return {}; }

  __device__ __forceinline__ void operator()(const Taps<int>& s, int* out) const {
    bool valid = true;
#pragma unroll
    for (int dr = -1; dr <= 1; ++dr) {
#pragma unroll
      for (int dc = -1; dc <= 1; ++dc) {
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

}  // namespace ss
