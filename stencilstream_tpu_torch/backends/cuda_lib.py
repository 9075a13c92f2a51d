"""Build and load the package's CUDA kernels.

The kernels are CUDA C++ under ``stencilstream_tpu_torch/csrc/``, compiled by
``nvcc`` for Hopper (``sm_90a``), one compiler process per source file, all
started together, and linked into one shared library with a plain C
interface, loaded with ``ctypes``. The library is built at first use into
``stencilstream_tpu_torch/_build/`` and rebuilt whenever a source file or the
compiler flags change (the file name carries their hash). Without ``nvcc``
the build raises; nothing falls back.

Each kernel entry point takes raw device pointers, ints and doubles, launches
on the stream it is given, allocates nothing, and returns the CUDA error code
of the launch (0 on success); :func:`check` turns a non-zero code into an
exception. A call's cell is bound to its functor once (:class:`Binding`): every
launch of the call shares the :class:`Binding`'s checks, C arrays and stream,
and its TDV stream, one more device pointer for a functor with a
time-dependent value (:meth:`Binding.stream_tdv`). A transition function on
narrow storage (``backends/storage_cast.py``: ``cuda_storage``) runs the
entry points ``<prefix><functor>__<storage>`` of the pairs in
:data:`NARROW_OPS`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from .. import tracing
from ..core.cell import cell_field_names, cell_leaves, cell_unflatten

__all__ = [
    "CSRC",
    "BUILD_DIR",
    "Binding",
    "NARROW_OPS",
    "build",
    "check",
    "check_field_dtypes",
    "library",
    "op_info",
    "pointer_array",
    "require_device_op",
    "tile_cell_smem_bytes",
    "tile_reach",
    "tile_writes",
]

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
#: The stencil kernels, each instantiated for every device functor
#: (``csrc/ops/all.cuh``).
STENCIL_SOURCES = ("tile_pass.cu", "monotile.cu", "line_cache.cu")
#: The ``experiments/`` microbenchmarks' kernels (``../experiments/``).
MICRO_SOURCES = ("micro_strip.cu", "micro_linecache.cu")
#: One nvcc process each, all started together.
SOURCES = STENCIL_SOURCES + MICRO_SOURCES

#: No FMA contraction: the kernels then round exactly like their plain
#: PyTorch versions, which evaluate one elementwise operation at a time
#: (a functor fuses a multiply-add only where it says so, with __fmaf_rn).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_PD = ctypes.POINTER(ctypes.c_double)
_I = ctypes.c_int

#: C signatures by entry-point prefix (the functor's name is appended). The
#: pointer after the halo doubles is the call's TDV stream (NULL for a
#: functor without a TDV).
_SIGNATURES = {
    "ss_tile_pass_": [_PP, _PP, _PP, *[_I] * 16, _PD, _PD, _P, _P],
    "ss_tile_pass_residency_": [_I, _I, _I, ctypes.POINTER(ctypes.c_int)],
    "ss_monotile_": [_PP, _PP, _PP, _I, _I, _I, _I, _I, _I, _I, _I, _PD, _PD, _P, _P, _P, ctypes.c_uint, _P],
    "ss_monotile_residency_": [_I, _I, _I, _I, ctypes.POINTER(ctypes.c_int)],
    "ss_line_cache_": [_PP, _PP, _PP, _I, _I, _I, _I, _I, _I, _I, _I, _I, _PD, _PD, _P, _P],
    "ss_line_cache_residency_": [_I, _I, _I, ctypes.POINTER(ctypes.c_int)],
    "ss_op_info_": [ctypes.POINTER(ctypes.c_int)],
    # (variant, p, x, out, H, W, T, hp, 16 host floats of scalars, stream)
    "ss_micro_strip": [_I, _I, _P, _P, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_float), _P],
    # (variant, p, x, out, H, W, Ha, T, chunk rows, stream)
    "ss_micro_linecache": [_I, _I, _P, _P, *[_I] * 5, _P],
}


@dataclasses.dataclass(frozen=True)
class DeviceLimits:
    """What the capacity laws of ``tiling`` and ``monotile`` read."""

    sm_count: int
    #: dynamic shared memory one block may opt into, in bytes
    smem_per_block: int


#: NVIDIA H100 SXM: 132 SMs, 227 KB of shared memory per block. A CPU grid is
#: planned as if for this card, so that ``auto`` and the tile choice come out
#: on the CPU as they would on the card.
H100_SXM = DeviceLimits(sm_count=132, smem_per_block=232448)


def device_limits(device) -> DeviceLimits:
    """The limits of a CUDA device, read from its properties; H100 SXM's
    for a CPU device."""
    device = torch.device(device)
    if device.type != "cuda":
        return H100_SXM
    props = torch.cuda.get_device_properties(device)
    return DeviceLimits(props.multi_processor_count, props.shared_memory_per_block_optin)


def fit_shared_memory(need, geometry, p: int, auto_p: bool, shrink, limits: DeviceLimits, sized_for: int, describe):
    """The line-cache law's shrinking loop. While ``need(geometry, p)``
    bytes exceed the shared memory a block may use divided by ``sized_for``
    (so that that many CTAs share an SM), shrink the geometry
    (``shrink(geometry)``, ``None`` when it is smallest), then ``p`` when it
    was not given. Returns ``(geometry, p)``; raises ``ValueError``, naming
    ``describe(geometry, p)``, when the result exceeds all of it."""
    while need(geometry, p) > limits.smem_per_block // sized_for:
        if (smaller := shrink(geometry)) is not None:
            geometry = smaller
        elif auto_p and p > 1:
            p -= 1
        else:
            break
    if need(geometry, p) > limits.smem_per_block:
        raise ValueError(
            f"{describe(geometry, p)} needs {need(geometry, p)} B of shared memory; "
            f"the device allows {limits.smem_per_block} B per block"
        )
    return geometry, p


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    ``PATH``, else ``/usr/local/cuda/bin/nvcc``. Raises if there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA kernels "
        "of stencilstream_tpu_torch are built from source at first use"
    )


def source_hash() -> str:
    """Hash of every kernel source and header plus the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in CSRC.rglob("*") if p.suffix in (".cu", ".cuh")):
        h.update(str(path.relative_to(CSRC)).encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libstencil_kernels_{source_hash()}.so"


def build() -> tuple[Path, float, str]:
    """Compile the kernels unless the current sources are already built.

    Returns ``(library path, seconds spent compiling, ptxas report)``; the
    seconds are 0 when the library was already there.
    """
    target = library_path()
    log = target.with_suffix(".log")
    if target.exists():
        return target, 0.0, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objects = [str(Path(work) / (Path(src).stem + ".o")) for src in SOURCES]
        compiles = [
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / src)]
            for src, obj in zip(SOURCES, objects)
        ]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for c in compiles]
        outputs = [p.communicate()[0] for p in procs]
        report = "".join(outputs)
        for cmd, proc, out in zip(compiles, procs, outputs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
        tmp = str(Path(work) / "lib.so")
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objects]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        log.write_text(report)
        os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    return target, time.perf_counter() - start, report


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.ss_error_string.argtypes = [ctypes.c_int]
    lib.ss_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def entry(prefix: str, op: str):
    """The C entry point ``<prefix><op>`` with its signature declared."""
    fn = getattr(library(), prefix + op, None)
    if fn is None:
        raise NotImplementedError(
            f"no CUDA kernel instantiated for device functor {op!r} ({prefix}{op}); "
            f"add it to the csrc/*.cu entry lists"
        )
    fn.argtypes = _SIGNATURES[prefix]
    fn.restype = ctypes.c_int
    return fn


#: Element dtypes by (bytes, kind) as ``ss_op_info_`` reports them: kind 0
#: integer, 1 IEEE float, 2 bfloat16, 3 float8 e4m3fn
#: (``csrc/tile_pass.cu:element_kind``).
_DTYPES = {
    (4, 1): torch.float32, (8, 1): torch.float64, (4, 0): torch.int32, (1, 0): torch.uint8,
    (2, 2): torch.bfloat16, (1, 3): torch.float8_e4m3fn,
}

#: The suffix of a narrow storage dtype in an entry point's name.
STORAGE_SUFFIX = {torch.bfloat16: "bf16", torch.float8_e4m3fn: "e4m3"}

#: The (device functor, storage dtype) pairs built on narrow storage
#: (``csrc/ops/all.cuh:SS_FOR_EACH_NARROW_OP``): the cells the JAX package's
#: bench stores as bfloat16, and Jacobi5 in float8 e4m3.
NARROW_OPS = frozenset({
    ("hotspot", torch.bfloat16),
    ("jacobi5_general", torch.bfloat16),
    ("fdtd_coef", torch.bfloat16),
    ("jacobi5_general", torch.float8_e4m3fn),
})


def kernel_view(t: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """The tensor as a kernel takes it, as a view of the same bytes (no
    copy): a bool field as uint8; an int32 field as ``dtype`` float32, for a
    float32 functor that only copies the field's bits (an invariant field
    that it reinterprets, as FDTD's ring index); any other field as it is."""
    if t.dtype == torch.bool:
        return t.view(torch.uint8)
    if t.dtype == torch.int32 and dtype == torch.float32:
        return t.view(torch.float32)
    return t


def widened(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An invariant field as a functor of element ``dtype`` takes it: a
    bool field beside floating fields (the folded convection cell's masks)
    widened to ``dtype``, 0 or 1, a copy made on the field's device for the
    launch, since a functor has one element type; any other field as
    :func:`kernel_view` gives it."""
    if t.dtype == torch.bool and dtype.is_floating_point:
        return t.to(dtype)
    return kernel_view(t, dtype)


def _halo_bits(value: Any, field: torch.Tensor, view: torch.Tensor) -> float:
    """A halo value as the kernel's double for ``view`` of ``field``: an
    int32 value read as float32 bits keeps its bits."""
    if field.dtype != torch.int32 or view.dtype != torch.float32:
        return value
    bits = float(np.array(value, np.int32).view(np.float32))
    if bits != bits:
        raise ValueError(f"halo value {value} of an int32 field read as float32 bits is a NaN")
    return bits


@functools.cache
def op_info(op: str) -> dict:
    """The functor's shape as compiled: radius, sub-iterations, field
    counts, parameter count, element dtype, the dtype of its
    time-dependent value (``None`` when it takes none), ``vector_map``,
    whether the tile pass's interior sub-steps take the vector thread map
    (``csrc/tile_pass.cu``: ``vector_map``), and ``writes``, the variant
    fields each sub-step writes as bit masks (bit j: variant field j) when
    the tile pass updates the cells in place (``in_place``), else ``None``,
    and ``reach``, the rows and columns each sub-step reads below and above
    a cell, ``(lo, hi)`` per sub-step, when the functor declares them
    (``declares_reach``), else ``None``."""
    info = (ctypes.c_int * 13)()
    entry("ss_op_info_", op)(info)
    keys = ("radius", "n_subiterations", "n_variant", "n_invariant", "n_params")
    out = dict(zip(keys, info))
    out["dtype"] = _DTYPES[(info[5], info[6])]
    out["tdv_dtype"] = _DTYPES[(info[7], info[8])] if info[7] else None
    out["vector_map"] = bool(info[9])
    nv = info[2]
    out["writes"] = tuple(info[10] >> (s * nv) & ((1 << nv) - 1) for s in range(info[1])) if info[10] else None
    reach = tuple((info[12] >> 8 * s & 15, info[12] >> 8 * s + 4 & 15) for s in range(info[1]))
    out["reach"] = reach if info[11] else None
    return out


def require_device_op(tf: Any, offset: int = 0) -> str:
    """The name of ``tf``'s device functor: ``<cuda_op>__<storage>`` for one
    on narrow storage (``cuda_storage``). Raises ``NotImplementedError``,
    naming the transition function, when it has none, when it has a
    time-dependent value (at ``offset``) but names no type for it
    (``cuda_tdv``, the torch dtype of the stream its functor reads), and
    when its functor is not built on its storage (:data:`NARROW_OPS`)."""
    op = getattr(tf, "cuda_op", None)
    if not isinstance(op, str) or not callable(getattr(tf, "cuda_params", None)):
        raise NotImplementedError(
            f"transition function {type(tf).__name__} names no device functor "
            f"(cuda_op / cuda_variant / cuda_params), so it cannot run on the "
            f"CUDA kernels; use the 'reference' backend for it"
        )
    if getattr(tf, "cuda_tdv", None) is None and tf.get_time_dependent_value(int(offset)) is not None:
        raise NotImplementedError(
            f"transition function {type(tf).__name__} has a time-dependent value, but "
            f"its device functor {op!r} takes none (cuda_tdv names the type of one)"
        )
    storage = getattr(tf, "cuda_storage", None)
    if storage is None:
        return op
    if (op, storage) not in NARROW_OPS:
        built = ", ".join(f"{o} on {d}" for o, d in sorted(NARROW_OPS, key=str))
        raise NotImplementedError(
            f"device functor {op!r} is not built on {storage} storage (the narrow kernels "
            f"are {built}: csrc/ops/all.cuh); use the 'reference' backend for it"
        )
    return f"{op}__{STORAGE_SUFFIX[storage]}"


class Binding:
    """A call's cell bound to its transition function's compiled functor,
    once a call: the checks, the variant/invariant split, the invariant
    fields' pointers (a bool field beside floating ones widened once:
    :func:`widened`), the parameters and halo values as C arrays and the
    stream, which every launch of the call shares (:meth:`launch`), and the
    call's TDV stream (:meth:`stream_tdv`).

    Raises ``NotImplementedError`` for a transition function without a
    device functor, or with a time-dependent value that its functor does
    not take, and ``TypeError``/``ValueError`` for fields the functor does
    not take. A CPU cell is not checked and ``op`` is ``None``: the binding
    holds the call's inputs for the kernels' plain versions.
    """

    def __init__(self, arrays: Any, tf: Any, halo_cell: Any, offset: int, n_iterations: int):
        self.tf, self.halo_cell, self.offset, self.n_iterations = tf, halo_cell, offset, n_iterations
        leaves = cell_leaves(arrays)
        self.device = leaves[0].device
        self.op = self.tdv = self.tdv_pointer = None
        if self.device.type == "cpu":
            return
        op = require_device_op(tf, offset)
        info = op_info(op)
        names = cell_field_names(arrays)
        variant_names = tuple(getattr(tf, "cuda_variant", ()))
        if names:
            unknown = set(variant_names) - set(names)
            if unknown:
                raise ValueError(f"cuda_variant names fields the cell lacks: {sorted(unknown)}")
            variant_index = [names.index(n) for n in variant_names]
        else:
            variant_index = [0]
        invariant_index = [j for j in range(len(leaves)) if j not in variant_index]
        params = [float(v) for v in tf.cuda_params()]
        expect = (tf.stencil_radius, tf.n_subiterations, len(variant_index), len(invariant_index), len(params))
        got = tuple(info[k] for k in ("radius", "n_subiterations", "n_variant", "n_invariant", "n_params"))
        if expect != got:
            raise ValueError(
                f"{type(tf).__name__} (radius, sub-iterations, variant fields, invariant "
                f"fields, params) = {expect}, but functor {op!r} is compiled for {got}"
            )
        if getattr(tf, "cuda_tdv", None) != info["tdv_dtype"]:
            raise NotImplementedError(
                f"{type(tf).__name__} declares a time-dependent value of type "
                f"{getattr(tf, 'cuda_tdv', None)}, but functor {op!r} takes {info['tdv_dtype']}"
            )
        views = [
            widened(t, info["dtype"]) if j in invariant_index else kernel_view(t)
            for j, t in enumerate(leaves)
        ]
        shape = tuple(views[0].shape)
        check_field_dtypes(op, info["dtype"], names, leaves, views)
        for t in views:
            if t.device != self.device or t.device.type != "cuda":
                raise ValueError(f"every field must lie on one CUDA device (got {t.device})")
            if tuple(t.shape) != shape or t.dim() != 2:
                raise ValueError(f"fields must be 2D of one shape (got {tuple(t.shape)} vs {shape})")
            if not t.is_contiguous():
                raise ValueError("fields must be contiguous")
        halo = [_halo_bits(h, s, v) for h, s, v in zip(cell_leaves(halo_cell), leaves, views)]
        self.op, self.variant_index = op, variant_index
        self.invariant = [views[j] for j in invariant_index]  # held while their pointers are
        self.invariant_pointers = pointer_array(self.invariant)
        self.params = double_array(params)
        self.halo = double_array([halo[j] for j in variant_index + invariant_index])
        self.stream = torch.cuda.current_stream(self.device).cuda_stream

    def stream_tdv(self, stream: Any) -> None:
        """Take the call's TDV stream. A kernel reads it through
        ``tdv_pointer``: NULL (``None``) for a functor without a
        time-dependent value or a call of no iterations (no step reads it);
        else the stream's, which must be one contiguous tensor of at least
        ``n_iterations`` values of the functor's type on the grid's device,
        or it cannot reach a kernel: ``ValueError``."""
        self.tdv = stream
        dtype, n, device = getattr(self.tf, "cuda_tdv", None), self.n_iterations, self.device
        if self.op is None or dtype is None or n == 0:
            return
        if not (
            isinstance(stream, torch.Tensor) and stream.dtype == dtype and stream.device == device
            and stream.dim() == 1 and stream.shape[0] >= n and stream.is_contiguous()
        ):
            got = (
                f"{stream.dtype} {tuple(stream.shape)} on {stream.device}" if isinstance(stream, torch.Tensor)
                else type(stream).__name__
            )
            raise ValueError(
                f"the time-dependent value of {type(self.tf).__name__} cannot be streamed to a kernel: it "
                f"takes one contiguous {dtype} tensor of {n} values on {device}, got {got}"
            )
        self.tdv_pointer = stream.data_ptr()

    def launch(self, prefix: str, arrays: Any, out: Any, *geometry: int, shape=None, extra=(), what: str) -> Any:
        """Enqueue ``<prefix><functor>`` from the variant fields of ``arrays``
        (the bound cell or an earlier launch's result) into new tensors of
        ``shape`` (the fields' by default) or those of ``out`` (a cell
        written in place, checked against the fields), the kernel's
        ``geometry`` integers before the parameters and ``extra`` arguments
        after the TDV pointer; raise on a CUDA error, naming ``what``. Returns
        ``arrays`` with its variant fields replaced by the outputs (viewed
        back as bool where the field is bool)."""
        leaves = cell_leaves(arrays)
        src = [kernel_view(leaves[j]) for j in self.variant_index]
        shape = tuple(src[0].shape) if shape is None else tuple(shape)
        if out is None:
            dst = [torch.empty(shape, dtype=t.dtype, device=t.device) for t in src]
        else:
            dst = [kernel_view(cell_leaves(out)[j]) for j in self.variant_index]
            for d, s in zip(dst, src):
                if tuple(d.shape) != shape or d.dtype != s.dtype or d.device != s.device:
                    raise ValueError("out must match the grid's fields")
                if not d.is_contiguous() or d.data_ptr() == s.data_ptr():
                    raise ValueError("out must be contiguous and must not be the input")
        fn = entry(prefix, self.op)
        with torch.cuda.device(self.device):
            args = (
                pointer_array(src), pointer_array(dst), self.invariant_pointers, *geometry,
                self.params, self.halo, self.tdv_pointer, *extra, self.stream,
            )
            with tracing.span("kernels.enqueue") if tracing.on else tracing.OFF:
                code = fn(*args)
        check(code, what)
        for j, t in zip(self.variant_index, dst):
            leaves[j] = t.view(torch.bool) if leaves[j].dtype == torch.bool else t
        return cell_unflatten(arrays, leaves)


def check_field_dtypes(op: str, dtype: torch.dtype, names, stored, views) -> None:
    """Raise ``TypeError``, naming the field and both dtypes, when a field
    (``stored``, as the kernel views it: ``views``) is not of the functor's
    element ``dtype``: a functor has one, so a cell that mixes storage types
    (an int32 field beside bfloat16 ones) has no kernel."""
    for j, (t, v) in enumerate(zip(stored, views)):
        if v.dtype != dtype:
            field = f"field {names[j]!r}" if names else "the cell"
            raise TypeError(f"functor {op!r} takes {dtype} fields, but {field} is {t.dtype}")


def cell_field_bytes(arrays: Any, tf: Any) -> tuple[int, int]:
    """Bytes of one cell's variant fields and of its invariant fields, as
    the kernels hold them: a bool invariant field beside floating variant
    fields at their width (:func:`widened`). Without a device functor every
    field counts as variant."""
    names = cell_field_names(arrays)
    variant = getattr(tf, "cuda_variant", names)
    leaves = cell_leaves(arrays)
    invariant = [bool(names) and names[j] not in variant for j in range(len(leaves))]
    floats = [t for t, inv in zip(leaves, invariant) if not inv and t.dtype.is_floating_point]
    sizes = [0, 0]
    for t, inv in zip(leaves, invariant):
        wide = inv and t.dtype == torch.bool and floats
        sizes[inv] += floats[0].element_size() if wide else t.element_size()
    return sizes[0], sizes[1]


def cell_traffic_bytes(arrays: Any, tf: Any) -> tuple[int, int]:
    """Bytes of one cell that a pass must read and write at the least: each
    variant field read and written, and of the invariant fields those the
    functor reads (``tf.cuda_invariant_reads``, every one when it names
    none). The kernels stage every invariant field all the same."""
    names = cell_field_names(arrays)
    variant = getattr(tf, "cuda_variant", names)
    reads = getattr(tf, "cuda_invariant_reads", None)
    read = written = 0
    for j, t in enumerate(cell_leaves(arrays)):
        if not names or names[j] in variant:
            read += t.element_size()
            written += t.element_size()
        elif reads is None or names[j] in reads:
            read += t.element_size()
    return read, written


def cell_smem_bytes(arrays: Any, tf: Any) -> int:
    """Shared-memory bytes one cell takes in the resident-grid kernel and in
    the tile pass of a functor that does not update in place: two ping-pong
    copies of each variant field, one staged copy of each invariant field
    (``csrc/common.cuh:cell_smem_bytes``)."""
    variant, invariant = cell_field_bytes(arrays, tf)
    return 2 * variant + invariant


def tile_writes(tf: Any) -> tuple[int, ...] | None:
    """The variant fields each sub-step of ``tf``'s device functor writes,
    as bit masks (bit j: ``tf.cuda_variant[j]``), when the tile pass updates
    its cells in place; else ``None``. The transition function names them
    (``cuda_writes``: the fields of each sub-step) as its functor declares
    them (``csrc/tile_pass.cu``: ``in_place``, :func:`op_info`'s
    ``writes``); narrow storage's functors declare none."""
    writes = getattr(tf, "cuda_writes", None)
    if writes is None or getattr(tf, "cuda_storage", None) is not None:
        return None
    variant = tuple(tf.cuda_variant)
    return tuple(sum(1 << variant.index(f) for f in fields) for fields in writes)


def tile_reach(tf: Any) -> tuple[tuple[int, int], ...] | None:
    """The rows and columns each sub-step of ``tf``'s device functor reads
    below and above a cell, ``(lo, hi)`` per sub-step, when the functor
    declares them; else ``None``. The transition function names them
    (``cuda_reach``) as its functor declares them (``csrc/tile_pass.cu``:
    ``reach``, :func:`op_info`'s ``reach``); narrow storage's functors
    declare none."""
    reach = getattr(tf, "cuda_reach", None)
    if reach is None or getattr(tf, "cuda_storage", None) is not None:
        return None
    return tuple((int(lo), int(hi)) for lo, hi in reach)


def tile_cell_smem_bytes(arrays: Any, tf: Any) -> int:
    """Shared-memory bytes one cell takes in the tile-pass kernel: one plane
    per variant field where it updates the cells in place
    (:func:`tile_writes`), else two; one per invariant field
    (``csrc/tile_pass.cu:tile_smem_bytes``)."""
    variant, invariant = cell_field_bytes(arrays, tf)
    return (1 if tile_writes(tf) else 2) * variant + invariant


def check(code: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if code != 0:
        msg = library().ss_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


def pointer_array(tensors) -> ctypes.Array:
    """A C array of the tensors' device pointers (a NULL for an empty list)."""
    ptrs = [t.data_ptr() for t in tensors] or [0]
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def double_array(values) -> ctypes.Array:
    vals = [float(v) for v in values] or [0.0]
    return (ctypes.c_double * len(vals))(*vals)
