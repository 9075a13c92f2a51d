// Thermal-convection device functors: the C++ twins of
// stencilstream_tpu_torch/models/convection.py:PseudoTransientKernel,
// FoldedPseudoTransientKernel and ThermalSolverKernel, in float32 and
// float64.
//
// The cell's 11 fields, in storage order: T, Pt, Vx, Vy, tau_xx, tau_yy,
// sigma_xy, dVxd_tau, dVyd_tau, ErrV, ErrP. The active region is (nx, ny)
// inside an (nx+1, ny+1) grid; x is the row (Taps::row), y the column
// (Taps::col), and the reference's coordinate guards are branches against
// the nx, ny parameters. Every tap that can lie outside the grid is
// guarded, so the halo value never reaches a cell of the grid.
//
// The updates keep the Python twins' association term by term and fuse the
// multiply-adds that XLA fuses in the JAX package's kernels (__fmaf_rn or
// __fma_rn, by T; the kernels are built with -fmad=false, so nothing else
// is contracted). With ax = d_xa_vx*inv_dx and ay = d_ya_vy*inv_dy:
//   sub-step 0: dV1 = fma(d_xa_vx, inv_dx, ay), dV2 = fma(d_ya_vy, inv_dy, ax)
//     (XLA fuses the other product in each output), eta = eta0 * fma(T +
//     deltaT/2, -dedT, 1), Pt = fma(dV1, -dtau/beta, Pt), tau_xx = (2 eta)
//     * fma(dV2, -1/3, ax), tau_yy = (2 eta) * fma(dV1, -1/3, ay),
//     sigma_xy = eta * fma(d_xi_vy, inv_dx, d_yi_vx*inv_dy);
//   sub-step 1: Rx = (1/rho) * fma(dPx, -inv_dx, fma(dsx, inv_dy,
//     dtxx*inv_dx)), Ry = (1/rho) * fma(Tm, g, fma(dPy, -inv_dy, fma(dsy,
//     inv_dx, dtyy*inv_dy))), dV?d = fma(dV?d, damp?, R?*dtau), V? =
//     fma(dV?d, dtau, V?);
//   thermal sub-step 0: qx = fma(d2, qcx, -(qcx*d1)), qy = fma(d4, qcy,
//     -(qcy*d3)), dT = -fma(qx, inv_dx, qy*inv_dy), the four upwind terms
//     unfused, T = fma(dT, dt, T).
// Scalar reciprocals and quotients arrive as parameters computed on the host
// in T, as JAX computes them on its traced scalars.
//
// The straight pseudo-transient functors run in place in the tile pass
// (tile_pass.cu: in_place), as FDTD's do: each sub-step declares the fields
// it changes (kWrites) and reads a changed field only at the cell itself,
// with one exception. Sub-step 2 reads Vx at (0, +-1) in columns 0 and
// ny - 1 and Vy at (+-1, 0) in rows 0 and nx - 1, fields it changes, but
// only in those columns and rows: with nx >= 3 and ny >= 3 the cells it
// reads there (columns 1 and ny - 2, rows 1 and nx - 2) keep their bits
// through the sub-step, so a lane reads the same value whether or not the
// lane that owns that cell has stored it. Smaller active regions would race:
// the transition function refuses them (models/convection.py:
// PseudoTransientKernel.cuda_params). Sub-step 2's reach (kReach below)
// stays 1 on both sides although only those boundary rows and columns take
// its taps, since the taps lie next to the cell. The thermal functor reads
// T at its neighbours in the sub-step that changes T, and the folded
// functors run on no cell: both keep the ping-pong map.
#pragma once

#include "../common.cuh"

namespace ss {

template <class T>
__device__ __forceinline__ T fused_multiply_add(T a, T b, T c);
template <>
__device__ __forceinline__ float fused_multiply_add(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
template <>
__device__ __forceinline__ double fused_multiply_add(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// Pseudo-transient momentum/pressure update, k=3. Variant fields: Pt, Vx,
// Vy, tau_xx, tau_yy, sigma_xy, dVxd_tau, dVyd_tau, then ErrV, ErrP with
// kWithErr; invariant: T (and ErrV, ErrP, never read, without kWithErr).
// Parameters (PseudoTransientKernel.cuda_params()): nx, ny, inv_dx, inv_dy,
// 1/3, dtau/beta, dedT, eta0, deltaT/2, 1/rho, dtau, dampX, dampY,
// roh0_g_alpha.
template <class Real, bool kWithErr, class Self>
struct ConvectionPtOp {
  using T = Real;
  static constexpr int kRadius = 1;
  static constexpr int kSubiterations = 3;
  static constexpr int kVariant = kWithErr ? 10 : 8;
  static constexpr int kInvariant = kWithErr ? 1 : 3;
  static constexpr int kParams = 14;
  enum { kPt, kVx, kVy, kTauXX, kTauYY, kSigmaXY, kDVx, kDVy, kErrV, kErrP };
  static constexpr unsigned kErr = kWithErr ? 1u << kErrV | 1u << kErrP : 0u;
  // The fields each sub-step changes (the top of this file: in place):
  // Pt and the stresses, with ErrV and ErrP's snapshots; the velocities and
  // their pseudo-time derivatives; the boundary velocities, with the errors.
  static constexpr unsigned kWrites[kSubiterations] = {
      1u << kPt | 1u << kTauXX | 1u << kTauYY | 1u << kSigmaXY | kErr,
      1u << kVx | 1u << kVy | 1u << kDVx | 1u << kDVy,
      1u << kVx | 1u << kVy | kErr,
  };
  // Each sub-step's reach, {lo, hi}: sub-step 0 reads only above and right
  // of the cell (Vx at (+1, 0) and (+1, +1), Vy at (0, +1) and (+1, +1));
  // sub-step 1 only below and left (tau_xx at (-1, 0), sigma_xy at (-1, 0),
  // (-1, -1) and (0, -1), Pt at (-1, 0) and (0, -1), tau_yy and T at
  // (0, -1)); sub-step 2 both sides (the boundary velocities). An iteration
  // widens the dependency cone by 2 a side, so the tile pass stages a halo
  // of 2p, not r*p*k = 3p (tile_pass.cu: pass_halo).
  static constexpr Reach kReach[kSubiterations] = {{0, 1}, {1, 0}, {1, 1}};

  int nx, ny;
  T inv_dx, inv_dy, third, dtau_beta, dedT, eta0, half_deltaT, inv_rho, dtau, dampX, dampY, g;

  static Self from_params(const double* p) {
    Self op{};
    op.nx = static_cast<int>(p[0]);
    op.ny = static_cast<int>(p[1]);
    T* dst[] = {&op.inv_dx, &op.inv_dy, &op.third, &op.dtau_beta, &op.dedT, &op.eta0,
                &op.half_deltaT, &op.inv_rho, &op.dtau, &op.dampX, &op.dampY, &op.g};
    for (int j = 0; j < kParams - 2; ++j) *dst[j] = static_cast<T>(p[2 + j]);
    return op;
  }

  template <class Tp>
  __device__ __forceinline__ void operator()(const Tp& s, T* out) const {
    const int x = s.row, y = s.col;
#pragma unroll
    for (int f = 0; f < kVariant; ++f) out[f] = s.v(f, 0, 0);
    if (s.subiteration == 0) {
      const bool mask_p = x < nx && y < ny;
      if constexpr (kWithErr) {
        if (x < nx && y < ny + 1) out[kErrV] = s.v(kVy, 0, 0);
        if (mask_p) out[kErrP] = s.v(kPt, 0, 0);
      }
      if (!mask_p) return;
      const T d_xa_vx = s.v(kVx, 1, 0) - s.v(kVx, 0, 0);
      const T d_ya_vy = s.v(kVy, 0, 1) - s.v(kVy, 0, 0);
      const T ax = d_xa_vx * inv_dx;
      const T ay = d_ya_vy * inv_dy;
      const T dV1 = fused_multiply_add(d_xa_vx, inv_dx, ay);
      const T dV2 = fused_multiply_add(d_ya_vy, inv_dy, ax);
      const T eta = eta0 * fused_multiply_add(s.i(0, 0, 0) + half_deltaT, -dedT, T(1));
      const T two_eta = T(2) * eta;
      out[kPt] = fused_multiply_add(dV1, -dtau_beta, s.v(kPt, 0, 0));
      out[kTauXX] = two_eta * fused_multiply_add(dV2, -third, ax);
      out[kTauYY] = two_eta * fused_multiply_add(dV1, -third, ay);
      if (x < nx - 1 && y < ny - 1) {
        const T d_yi_vx = s.v(kVx, 1, 1) - s.v(kVx, 1, 0);
        const T d_xi_vy = s.v(kVy, 1, 1) - s.v(kVy, 0, 1);
        out[kSigmaXY] = eta * fused_multiply_add(d_xi_vy, inv_dx, d_yi_vx * inv_dy);
      }
      return;
    }
    if (s.subiteration == 1) {
      if (x < 1 || y < 1) return;
      if (x < nx && y < ny - 1) {
        const T dtxx = s.v(kTauXX, 0, 0) - s.v(kTauXX, -1, 0);
        const T dsx = s.v(kSigmaXY, -1, 0) - s.v(kSigmaXY, -1, -1);
        const T dPx = s.v(kPt, 0, 0) - s.v(kPt, -1, 0);
        const T Rx = inv_rho * fused_multiply_add(dPx, -inv_dx,
                                                  fused_multiply_add(dsx, inv_dy, dtxx * inv_dx));
        const T dv = fused_multiply_add(s.v(kDVx, 0, 0), dampX, Rx * dtau);
        out[kDVx] = dv;
        out[kVx] = fused_multiply_add(dv, dtau, s.v(kVx, 0, 0));
      }
      if (x < nx - 1 && y < ny) {
        const T dtyy = s.v(kTauYY, 0, 0) - s.v(kTauYY, 0, -1);
        const T dsy = s.v(kSigmaXY, 0, -1) - s.v(kSigmaXY, -1, -1);
        const T dPy = s.v(kPt, 0, 0) - s.v(kPt, 0, -1);
        const T Tm = (s.i(0, 0, -1) + s.i(0, 0, 0)) * T(0.5);
        const T sy = fused_multiply_add(dPy, -inv_dy, fused_multiply_add(dsy, inv_dx, dtyy * inv_dy));
        const T Ry = inv_rho * fused_multiply_add(Tm, g, sy);
        const T dv = fused_multiply_add(s.v(kDVy, 0, 0), dampY, Ry * dtau);
        out[kDVy] = dv;
        out[kVy] = fused_multiply_add(dv, dtau, s.v(kVy, 0, 0));
      }
      return;
    }
    // Sub-step 2: boundary conditions and the error update.
    if (x < nx + 1 && y < ny) {
      if (y == 0) out[kVx] = s.v(kVx, 0, 1);
      if (y == ny - 1) out[kVx] = s.v(kVx, 0, -1);
    }
    const bool mask_bcy = x < nx && y < ny + 1;
    if (mask_bcy) {
      if (x == 0) out[kVy] = s.v(kVy, 1, 0);
      if (x == nx - 1) out[kVy] = s.v(kVy, -1, 0);
    }
    if constexpr (kWithErr) {
      if (mask_bcy) out[kErrV] = s.v(kErrV, 0, 0) - out[kVy];
      if (x < nx && y < ny) out[kErrP] = s.v(kErrP, 0, 0) - s.v(kPt, 0, 0);
    }
  }
};

// Thermal advection/diffusion update, k=2. Variant field: T; invariant: the
// other ten (Pt 0, Vx 1, Vy 2, ...), of which it reads Vx and Vy.
// Parameters (ThermalSolverKernel.cuda_params()): nx, ny, inv_dx, inv_dy,
// qcx = -DcT*inv_dx, qcy = -DcT*inv_dy, dt.
template <class Real, class Self>
struct ConvectionThermalOp {
  using T = Real;
  static constexpr int kRadius = 1;
  static constexpr int kSubiterations = 2;
  static constexpr int kVariant = 1;
  static constexpr int kInvariant = 10;
  static constexpr int kParams = 7;
  enum { kVx = 1, kVy = 2 };

  int nx, ny;
  T inv_dx, inv_dy, qcx, qcy, dt;

  static Self from_params(const double* p) {
    Self op{};
    op.nx = static_cast<int>(p[0]);
    op.ny = static_cast<int>(p[1]);
    op.inv_dx = static_cast<T>(p[2]);
    op.inv_dy = static_cast<T>(p[3]);
    op.qcx = static_cast<T>(p[4]);
    op.qcy = static_cast<T>(p[5]);
    op.dt = static_cast<T>(p[6]);
    return op;
  }

  template <class Tp>
  __device__ __forceinline__ void operator()(const Tp& s, T* out) const {
    const int x = s.row, y = s.col;
    const T c = s.v(0, 0, 0);
    out[0] = c;
    if (s.subiteration == 0) {
      if (!(x > 0 && y > 0 && x < nx - 1 && y < ny - 1)) return;
      const T d1 = c - s.v(0, -1, 0);
      const T d2 = s.v(0, 1, 0) - c;
      const T d3 = c - s.v(0, 0, -1);
      const T d4 = s.v(0, 0, 1) - c;
      const T qx = fused_multiply_add(d2, qcx, -(qcx * d1));
      const T qy = fused_multiply_add(d4, qcy, -(qcy * d3));
      T dT = -fused_multiply_add(qx, inv_dx, qy * inv_dy);
      const T vx = s.i(kVx, 0, 0), vx1 = s.i(kVx, 1, 0);
      const T vy = s.i(kVy, 0, 0), vy1 = s.i(kVy, 0, 1);
      if (vx > T(0)) dT = dT - (vx * d1) * inv_dx;
      if (vx1 < T(0)) dT = dT - (vx1 * d2) * inv_dx;
      if (vy > T(0)) dT = dT - (vy * d3) * inv_dy;
      if (vy1 < T(0)) dT = dT - (vy1 * d4) * inv_dy;
      out[0] = fused_multiply_add(dT, dt, c);
      return;
    }
    // Sub-step 1: no_fluxY_T boundary conditions.
    if (x == nx - 1 && y < ny) out[0] = s.v(0, -1, 0);
    if (x == 0 && y < ny) out[0] = s.v(0, 1, 0);
  }
};

// The folded pseudo-transient update (FoldedPseudoTransientKernel), k=3: the
// straight update's mathematics with the coordinate guards read from 12
// invariant planes of the cell (models/convection.py:PLANES): 7 bool masks,
// which reach the kernels widened to T (0 or 1; backends/cuda_lib.py:
// kernel_fields), and 5 coefficient planes that fold the masks of Pt, dV?d
// and V? into multiply-adds, which therefore run on every cell: Pt =
// fma(dV1, -c_pt, Pt), dV?d = fma(dV?d, a_v?, c_v?*R?), V? = fma(dV?d, c_v?,
// V?). The other updates keep the straight functor's forms under the masks.
// Variant fields as ConvectionPtOp's; invariant: T, then (without kWithErr)
// ErrV and ErrP, then the planes. Parameters
// (FoldedPseudoTransientKernel.cuda_params()): inv_dx, inv_dy, 1/3, dedT,
// eta0, deltaT/2, 1/rho, roh0_g_alpha.
template <class Real, bool kWithErr, class Self>
struct ConvectionFoldedPtOp {
  using T = Real;
  static constexpr int kRadius = 1;
  static constexpr int kSubiterations = 3;
  static constexpr int kVariant = kWithErr ? 10 : 8;
  static constexpr int kInvariant = kWithErr ? 13 : 15;
  static constexpr int kParams = 8;
  enum { kPt, kVx, kVy, kTauXX, kTauYY, kSigmaXY, kDVx, kDVy, kErrV, kErrP };
  // The planes, in the cell's order, and the first one's invariant index.
  enum { kMV, kMP, kMSig, kCPt, kCVx, kAVx, kCVy, kAVy, kMBx0, kMBx1, kMBy0, kMBy1 };
  static constexpr int kFirstPlane = kWithErr ? 1 : 3;

  T inv_dx, inv_dy, third, dedT, eta0, half_deltaT, inv_rho, g;

  static Self from_params(const double* p) {
    Self op{};
    T* dst[] = {&op.inv_dx, &op.inv_dy, &op.third, &op.dedT, &op.eta0, &op.half_deltaT, &op.inv_rho, &op.g};
    for (int j = 0; j < kParams; ++j) *dst[j] = static_cast<T>(p[j]);
    return op;
  }

  template <class Tp>
  __device__ __forceinline__ static T plane(const Tp& s, int j) {
    return s.i(kFirstPlane + j, 0, 0);
  }
  template <class Tp>
  __device__ __forceinline__ static bool mask(const Tp& s, int j) {
    return plane(s, j) != T(0);
  }

  template <class Tp>
  __device__ __forceinline__ void operator()(const Tp& s, T* out) const {
#pragma unroll
    for (int f = 0; f < kVariant; ++f) out[f] = s.v(f, 0, 0);
    if (s.subiteration == 0) {
      if constexpr (kWithErr) {
        if (mask(s, kMV)) out[kErrV] = s.v(kVy, 0, 0);
        if (mask(s, kMP)) out[kErrP] = s.v(kPt, 0, 0);
      }
      const T d_xa_vx = s.v(kVx, 1, 0) - s.v(kVx, 0, 0);
      const T d_ya_vy = s.v(kVy, 0, 1) - s.v(kVy, 0, 0);
      const T ax = d_xa_vx * inv_dx;
      const T ay = d_ya_vy * inv_dy;
      const T dV1 = fused_multiply_add(d_xa_vx, inv_dx, ay);
      const T dV2 = fused_multiply_add(d_ya_vy, inv_dy, ax);
      const T eta = eta0 * fused_multiply_add(s.i(0, 0, 0) + half_deltaT, -dedT, T(1));
      const T two_eta = T(2) * eta;
      out[kPt] = fused_multiply_add(dV1, -plane(s, kCPt), s.v(kPt, 0, 0));
      if (mask(s, kMP)) {
        out[kTauXX] = two_eta * fused_multiply_add(dV2, -third, ax);
        out[kTauYY] = two_eta * fused_multiply_add(dV1, -third, ay);
      }
      if (mask(s, kMSig)) {
        const T d_yi_vx = s.v(kVx, 1, 1) - s.v(kVx, 1, 0);
        const T d_xi_vy = s.v(kVy, 1, 1) - s.v(kVy, 0, 1);
        out[kSigmaXY] = eta * fused_multiply_add(d_xi_vy, inv_dx, d_yi_vx * inv_dy);
      }
      return;
    }
    if (s.subiteration == 1) {
      const T dtxx = s.v(kTauXX, 0, 0) - s.v(kTauXX, -1, 0);
      const T dsx = s.v(kSigmaXY, -1, 0) - s.v(kSigmaXY, -1, -1);
      const T dPx = s.v(kPt, 0, 0) - s.v(kPt, -1, 0);
      const T Rx = inv_rho * fused_multiply_add(dPx, -inv_dx, fused_multiply_add(dsx, inv_dy, dtxx * inv_dx));
      const T dvx = fused_multiply_add(s.v(kDVx, 0, 0), plane(s, kAVx), plane(s, kCVx) * Rx);
      out[kDVx] = dvx;
      out[kVx] = fused_multiply_add(dvx, plane(s, kCVx), s.v(kVx, 0, 0));
      const T dtyy = s.v(kTauYY, 0, 0) - s.v(kTauYY, 0, -1);
      const T dsy = s.v(kSigmaXY, 0, -1) - s.v(kSigmaXY, -1, -1);
      const T dPy = s.v(kPt, 0, 0) - s.v(kPt, 0, -1);
      const T Tm = (s.i(0, 0, -1) + s.i(0, 0, 0)) * T(0.5);
      const T sy = fused_multiply_add(dPy, -inv_dy, fused_multiply_add(dsy, inv_dx, dtyy * inv_dy));
      const T Ry = inv_rho * fused_multiply_add(Tm, g, sy);
      const T dvy = fused_multiply_add(s.v(kDVy, 0, 0), plane(s, kAVy), plane(s, kCVy) * Ry);
      out[kDVy] = dvy;
      out[kVy] = fused_multiply_add(dvy, plane(s, kCVy), s.v(kVy, 0, 0));
      return;
    }
    // Sub-step 2: boundary conditions and the error update.
    if (mask(s, kMBx0)) out[kVx] = s.v(kVx, 0, 1);
    if (mask(s, kMBx1)) out[kVx] = s.v(kVx, 0, -1);
    if (mask(s, kMBy0)) out[kVy] = s.v(kVy, 1, 0);
    if (mask(s, kMBy1)) out[kVy] = s.v(kVy, -1, 0);
    if constexpr (kWithErr) {
      if (mask(s, kMV)) out[kErrV] = s.v(kErrV, 0, 0) - out[kVy];
      if (mask(s, kMP)) out[kErrP] = s.v(kErrP, 0, 0) - s.v(kPt, 0, 0);
    }
  }
};

struct ConvectionPtF32Op : ConvectionPtOp<float, true, ConvectionPtF32Op> {};
struct ConvectionPtF64Op : ConvectionPtOp<double, true, ConvectionPtF64Op> {};
struct ConvectionPtLeanF32Op : ConvectionPtOp<float, false, ConvectionPtLeanF32Op> {};
struct ConvectionPtLeanF64Op : ConvectionPtOp<double, false, ConvectionPtLeanF64Op> {};
struct ConvectionThermalF32Op : ConvectionThermalOp<float, ConvectionThermalF32Op> {};
struct ConvectionThermalF64Op : ConvectionThermalOp<double, ConvectionThermalF64Op> {};
struct ConvectionFoldedPtF32Op : ConvectionFoldedPtOp<float, true, ConvectionFoldedPtF32Op> {};
struct ConvectionFoldedPtF64Op : ConvectionFoldedPtOp<double, true, ConvectionFoldedPtF64Op> {};
struct ConvectionFoldedPtLeanF32Op : ConvectionFoldedPtOp<float, false, ConvectionFoldedPtLeanF32Op> {};
struct ConvectionFoldedPtLeanF64Op : ConvectionFoldedPtOp<double, false, ConvectionFoldedPtLeanF64Op> {};

}  // namespace ss
