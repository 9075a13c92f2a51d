// Shared pieces of the stencil kernels: the neighbourhood view a device
// functor reads, the field pointers and halo values a launch carries, and the
// host-side argument unpacking of the plain C interface.
//
// A device functor ("Op", see ops/hotspot.cuh) is the C++ twin of a Python
// transition function. It declares
//   using T                   the element type of every cell field,
//   kRadius, kSubiterations   the stencil radius r and sub-steps k,
//   kVariant, kInvariant      how many cell fields it updates and how many
//                             it only reads (loop-invariant fields),
//   kParams                   how many scalar runtime parameters it takes,
//   from_params(const double*) building the functor from those scalars,
//   operator()(const Taps<T>&, T* out) writing the new variant fields.
// Its runtime parameters travel by value as a kernel argument on every
// launch, so changing them never rebuilds anything.
#pragma once

#include <cuda_runtime.h>

namespace ss {

// Neighbourhood of one cell. Variant fields come from the current ping-pong
// plane, invariant fields from their staged plane; all planes share one row
// pitch and carry the halo value outside the grid.
template <class T>
struct Taps {
  const T* var;       // variant field 0 at the central cell
  const T* inv;       // invariant field 0 at the central cell
  long var_stride;    // elements between two variant fields' planes
  long inv_stride;    // elements between two invariant fields' planes
  int pitch;          // row pitch of every plane
  int row, col;       // global coordinates of the central cell
  int H, W;           // logical grid extent
  int iteration;      // absolute iteration index
  int subiteration;

  // Variant field f at signed offset (dr, dc).
  __device__ __forceinline__ T v(int f, int dr, int dc) const {
    return var[f * var_stride + dr * pitch + dc];
  }
  // Invariant field f at signed offset (dr, dc).
  __device__ __forceinline__ T i(int f, int dr, int dc) const {
    return inv[f * inv_stride + dr * pitch + dc];
  }
};

constexpr int at_least_one(int n) { return n > 0 ? n : 1; }

// Field pointers and halo values of one launch, in the functor's order.
template <class Op>
struct Fields {
  using T = typename Op::T;
  const T* var_in[Op::kVariant];
  T* var_out[Op::kVariant];
  const T* inv[at_least_one(Op::kInvariant)];
  T halo_var[Op::kVariant];
  T halo_inv[at_least_one(Op::kInvariant)];
};

// Unpack the C interface's pointer arrays and halo doubles (variant fields
// first, then invariant fields).
template <class Op>
Fields<Op> make_fields(void* const* var_in, void* const* var_out, void* const* inv,
                       const double* halo) {
  using T = typename Op::T;
  Fields<Op> f{};
  for (int j = 0; j < Op::kVariant; ++j) {
    f.var_in[j] = static_cast<const T*>(var_in[j]);
    f.var_out[j] = static_cast<T*>(var_out[j]);
    f.halo_var[j] = static_cast<T>(halo[j]);
  }
  for (int j = 0; j < Op::kInvariant; ++j) {
    f.inv[j] = static_cast<const T*>(inv[j]);
    f.halo_inv[j] = static_cast<T>(halo[Op::kVariant + j]);
  }
  return f;
}

// Bytes of one window cell in shared memory: two ping-pong planes per
// variant field, one staged plane per invariant field.
template <class Op>
constexpr size_t cell_smem_bytes() {
  return sizeof(typename Op::T) * (2 * Op::kVariant + Op::kInvariant);
}

}  // namespace ss
