// Conway's Game of Life device functor: the C++ twin of
// stencilstream_tpu_torch/models/conway.py:ConwayKernel.
//
// One cell field, stored as uint8 (the port keeps cells as torch.bool and
// hands the kernels a uint8 view of the same bytes: 0 dead, 1 alive). The
// Moore neighbourhood's alive count decides birth (3) and survival (2, 3).
#pragma once

#include "../common.cuh"

namespace ss {

struct ConwayOp {
  using T = unsigned char;
  static constexpr int kRadius = 1;
  static constexpr int kSubiterations = 1;
  static constexpr int kVariant = 1;
  static constexpr int kInvariant = 0;
  static constexpr int kParams = 0;

  static ConwayOp from_params(const double*) { return {}; }

  template <class Tp>
  __device__ __forceinline__ void operator()(const Tp& s, unsigned char* out) const {
    int count = 0;
#pragma unroll
    for (int dr = -1; dr <= 1; ++dr)
#pragma unroll
      for (int dc = -1; dc <= 1; ++dc)
        if (dr != 0 || dc != 0) count += s.v(0, dr, dc) != 0;
    const bool alive = s.v(0, 0, 0) != 0;
    out[0] = (count == 3 || (alive && count == 2)) ? 1 : 0;
  }
};

}  // namespace ss
