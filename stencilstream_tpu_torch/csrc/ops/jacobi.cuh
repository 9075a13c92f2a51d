// Jacobi device functors: the C++ twins of the eight variants in
// stencilstream_tpu_torch/models/jacobi.py (one float32 field, radius 1).
//
// Each keeps the association and the fused multiply-adds with which XLA on
// the CPU evaluates the JAX package's variant, so the kernels, their plain
// PyTorch versions and the JAX oracle round alike (the kernels are built
// with -fmad=false; every fused step here is an explicit __fmaf_rn):
//   jacobi5_general, jacobi9_general: acc = c_center * t(0,0), then
//       acc = fma(t_i, c_i, acc) for each further term in source order
//       (jacobi5_general on bfloat16 cells: the second term unfused, as
//       XLA evaluates the JAX package's CastStorageKernel there);
//   jacobi4_general: acc = fma(t(-1,0), c0, c1 * t(0,-1)), then
//       fma(t(1,0), c2, acc), fma(t(0,1), c3, acc);
//   jacobi{2,3,4,5}_constant: sum left to right, then one multiply;
//   jacobi1_general: one multiply.
// Runtime parameters are the coefficients, in the order of the Python
// twin's cuda_params().
#pragma once

#include "../common.cuh"

namespace ss {

struct JacobiShape {
  using T = float;
  static constexpr int kRadius = 1;
  static constexpr int kSubiterations = 1;
  static constexpr int kVariant = 1;
  static constexpr int kInvariant = 0;
};

// Coefficients read from the launch's doubles, rounded to float32.
template <int N>
struct Coefficients {
  static constexpr int kParams = N;
  float c[N > 0 ? N : 1];

  template <class Op>
  static Op read(const double* p) {
    Op op{};
    for (int j = 0; j < N; ++j) op.c[j] = static_cast<float>(p[j]);
    return op;
  }
};

struct Jacobi1GeneralOp : JacobiShape, Coefficients<1> {
  static Jacobi1GeneralOp from_params(const double* p) { return read<Jacobi1GeneralOp>(p); }
  template <class Tp>
  __device__ __forceinline__ void operator()(const Tp& s, float* out) const {
    out[0] = c[0] * s.v(0, 0, 0);
  }
};

struct Jacobi2ConstantOp : JacobiShape, Coefficients<0> {
  static Jacobi2ConstantOp from_params(const double*) { return {}; }
  template <class Tp>
  __device__ __forceinline__ void operator()(const Tp& s, float* out) const {
    out[0] = (s.v(0, -1, 0) + s.v(0, 1, 0)) * 0.5f;
  }
};

struct Jacobi3ConstantOp : JacobiShape, Coefficients<0> {
  static Jacobi3ConstantOp from_params(const double*) { return {}; }
  template <class Tp>
  __device__ __forceinline__ void operator()(const Tp& s, float* out) const {
    out[0] = (s.v(0, 0, 0) + s.v(0, -1, 0) + s.v(0, 1, 0)) * 0.33333334f;
  }
};

struct Jacobi4ConstantOp : JacobiShape, Coefficients<0> {
  static Jacobi4ConstantOp from_params(const double*) { return {}; }
  template <class Tp>
  __device__ __forceinline__ void operator()(const Tp& s, float* out) const {
    out[0] = (s.v(0, -1, 0) + s.v(0, 0, -1) + s.v(0, 1, 0) + s.v(0, 0, 1)) * 0.25f;
  }
};

struct Jacobi5ConstantOp : JacobiShape, Coefficients<0> {
  static Jacobi5ConstantOp from_params(const double*) { return {}; }
  template <class Tp>
  __device__ __forceinline__ void operator()(const Tp& s, float* out) const {
    out[0] = (s.v(0, 0, 0) + s.v(0, -1, 0) + s.v(0, 0, -1) + s.v(0, 1, 0) + s.v(0, 0, 1)) * 0.2f;
  }
};

struct Jacobi4GeneralOp : JacobiShape, Coefficients<4> {
  static Jacobi4GeneralOp from_params(const double* p) { return read<Jacobi4GeneralOp>(p); }
  template <class Tp>
  __device__ __forceinline__ void operator()(const Tp& s, float* out) const {
    float acc = __fmaf_rn(s.v(0, -1, 0), c[0], c[1] * s.v(0, 0, -1));
    acc = __fmaf_rn(s.v(0, 1, 0), c[2], acc);
    out[0] = __fmaf_rn(s.v(0, 0, 1), c[3], acc);
  }
};

struct Jacobi5GeneralOp : JacobiShape, Coefficients<5> {
  static Jacobi5GeneralOp from_params(const double* p) { return read<Jacobi5GeneralOp>(p); }
  template <class Tp>
  __device__ __forceinline__ void operator()(const Tp& s, float* out) const {
    float acc = c[4] * s.v(0, 0, 0);
    acc = __fmaf_rn(s.v(0, -1, 0), c[0], acc);
    // On bfloat16 cells (Narrow) XLA leaves this multiply-add unfused.
    if constexpr (std::is_same<typename Tp::Storage, Bf16>::value)
      acc = acc + s.v(0, 0, -1) * c[1];
    else
      acc = __fmaf_rn(s.v(0, 0, -1), c[1], acc);
    acc = __fmaf_rn(s.v(0, 1, 0), c[2], acc);
    out[0] = __fmaf_rn(s.v(0, 0, 1), c[3], acc);
  }
};

struct Jacobi9GeneralOp : JacobiShape, Coefficients<9> {
  static Jacobi9GeneralOp from_params(const double* p) { return read<Jacobi9GeneralOp>(p); }
  template <class Tp>
  __device__ __forceinline__ void operator()(const Tp& s, float* out) const {
    float acc = c[4] * s.v(0, 0, 0);
#pragma unroll
    for (int dr = -1; dr <= 1; ++dr)
#pragma unroll
      for (int dc = -1; dc <= 1; ++dc)
        if (dr != 0 || dc != 0) acc = __fmaf_rn(s.v(0, dr, dc), c[(dr + 1) * 3 + dc + 1], acc);
    out[0] = acc;
  }
};

}  // namespace ss
