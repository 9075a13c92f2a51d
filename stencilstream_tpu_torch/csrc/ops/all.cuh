// Every device functor of the package, and the list that instantiates each
// kernel for each of them. SS_FOR_EACH_OP(X) expands X(name, Op) once per
// functor; every kernel source expands its entry macro over it, so every
// functor has an entry point in every kernel (ss_tile_pass_<name>,
// ss_monotile_<name>, ss_line_cache_<name>) and one ss_op_info_<name>.
// A new functor is one header under ops/ plus one line here.
#pragma once

#include "conway.cuh"
#include "hotspot.cuh"
#include "jacobi.cuh"
#include "probe.cuh"

#define SS_FOR_EACH_OP(X)                     \
  X(hotspot, ss::HotspotOp)                   \
  X(jacobi1_general, ss::Jacobi1GeneralOp)    \
  X(jacobi2_constant, ss::Jacobi2ConstantOp)  \
  X(jacobi3_constant, ss::Jacobi3ConstantOp)  \
  X(jacobi4_constant, ss::Jacobi4ConstantOp)  \
  X(jacobi5_constant, ss::Jacobi5ConstantOp)  \
  X(jacobi4_general, ss::Jacobi4GeneralOp)    \
  X(jacobi5_general, ss::Jacobi5GeneralOp)    \
  X(jacobi9_general, ss::Jacobi9GeneralOp)    \
  X(conway, ss::ConwayOp)                     \
  X(probe, ss::ProbeOp)
