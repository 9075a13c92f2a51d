// Every device functor of the package, and the list that instantiates each
// kernel for each of them. SS_FOR_EACH_OP(X) expands X(name, Op) once per
// functor; every kernel source expands its entry macro over it, so every
// functor has an entry point in every kernel (ss_tile_pass_<name>,
// ss_monotile_<name>, ss_line_cache_<name>) and one ss_op_info_<name>.
// A new functor is one header under ops/ plus one line here.
//
// SS_FOR_EACH_NARROW_OP(X) expands X(name, Op) for the functors that are
// also built on narrow storage (common.cuh: Narrow<Op, S>), so that each
// kernel has an entry point ss_<kernel>_<functor>__<storage> for them:
// HotSpot, Jacobi5 and FDTD's coef cell in bfloat16 (the storage the JAX
// package's bench runs them in), Jacobi5 in float8 e4m3. No other functor
// is instantiated narrow; backends/cuda_lib.py:NARROW_OPS lists the same
// pairs, and a transition function asking for another raises.
#pragma once

#include "convection.cuh"
#include "conway.cuh"
#include "fdtd.cuh"
#include "hotspot.cuh"
#include "jacobi.cuh"
#include "probe.cuh"

#define SS_FOR_EACH_OP(X)                                           \
  X(hotspot, ss::HotspotOp)                                         \
  X(jacobi1_general, ss::Jacobi1GeneralOp)                          \
  X(jacobi2_constant, ss::Jacobi2ConstantOp)                        \
  X(jacobi3_constant, ss::Jacobi3ConstantOp)                        \
  X(jacobi4_constant, ss::Jacobi4ConstantOp)                        \
  X(jacobi5_constant, ss::Jacobi5ConstantOp)                        \
  X(jacobi4_general, ss::Jacobi4GeneralOp)                          \
  X(jacobi5_general, ss::Jacobi5GeneralOp)                          \
  X(jacobi9_general, ss::Jacobi9GeneralOp)                          \
  X(conway, ss::ConwayOp)                                           \
  X(probe, ss::ProbeOp)                                             \
  X(probe_tdv, ss::ProbeTdvOp)                                      \
  X(probe_radius2, ss::ProbeRadius2Op)                              \
  X(fdtd_coef, ss::FdtdCoefOp)                                      \
  X(fdtd_lut, ss::FdtdLutOp)                                        \
  X(fdtd_render, ss::FdtdRenderOp)                                  \
  X(convection_pt_f32, ss::ConvectionPtF32Op)                       \
  X(convection_pt_f64, ss::ConvectionPtF64Op)                       \
  X(convection_pt_lean_f32, ss::ConvectionPtLeanF32Op)              \
  X(convection_pt_lean_f64, ss::ConvectionPtLeanF64Op)              \
  X(convection_thermal_f32, ss::ConvectionThermalF32Op)             \
  X(convection_thermal_f64, ss::ConvectionThermalF64Op)             \
  X(convection_folded_pt_f32, ss::ConvectionFoldedPtF32Op)          \
  X(convection_folded_pt_f64, ss::ConvectionFoldedPtF64Op)          \
  X(convection_folded_pt_lean_f32, ss::ConvectionFoldedPtLeanF32Op) \
  X(convection_folded_pt_lean_f64, ss::ConvectionFoldedPtLeanF64Op)

#define SS_FOR_EACH_NARROW_OP(X)                                       \
  X(hotspot__bf16, ss::Narrow<ss::HotspotOp, ss::Bf16>)                \
  X(jacobi5_general__bf16, ss::Narrow<ss::Jacobi5GeneralOp, ss::Bf16>) \
  X(fdtd_coef__bf16, ss::Narrow<ss::FdtdCoefOp, ss::Bf16>)             \
  X(jacobi5_general__e4m3, ss::Narrow<ss::Jacobi5GeneralOp, ss::E4m3>)
