"""The port's spans: where the host time of a call goes, layer by layer.

A span is one stretch of host time at a layer boundary of a call (the layers
of PERF.md §3). Every span of one user call, ``update(grid)``, carries that
call's id:

==========================  ==================================================
``entry.call``              the user call, in ``StencilUpdateBase.__call__``
                            (``auto``'s opens it, its delegate's opens no
                            second one); attributes ``backend``, ``H``, ``W``,
                            ``n``
``entry.check_no_grad``     the grad check of a call (``base.check_no_grad``)
``backends.choose``         ``auto``'s ``choose_backend`` and delegate lookup;
                            attribute ``backend``, the one chosen
``backends.plan``           the halo, the device's limits and the geometry
                            (``tiling``'s ``pick_config`` or
                            ``pick_linecache_config`` and its binding of the
                            call's cell to the functor, ``cuda_lib.Binding``;
                            ``monotile``'s ``require_plan``, or the plan
                            ``auto`` made; ``distributed``'s framed buffers
                            and its binding a block; ``ring``'s halo, chunk
                            rows and ``pick_config``); attribute ``geometry``
``backends.tdv``            the call's time-dependent value stream
                            (``StencilUpdateBase._tdv_stream``); attributes
                            ``strategy``, ``offset`` (the call's
                            ``iteration_offset``), ``n`` (its iterations)
``backends.shard``          ``distributed`` given a whole grid: the grid
                            padded and cut into blocks, each moved to its
                            mesh position's device
``backends.exchange``       ``distributed``, one a pass: the frame strips
                            copied between the blocks' buffers
                            (``parallel.exchange_frames``); attributes
                            ``pass_index``, ``strips`` (copies from a
                            neighbour), ``bytes`` (theirs). ``ring``, one a
                            copy between devices: a computed chunk sent to
                            the next position on another device, and the
                            lap's grid taken back by the root; attributes
                            ``pass_index`` (the pass whose output it
                            carries), ``bytes``
``backends.gather``         ``distributed`` given a whole grid: the blocks
                            joined on the grid's device
``kernels.launch``          one pass of a kernel, entry to return
                            (``bound_tile_pass``, ``bound_line_cache_pass``:
                            the geometry, the launch from the call's binding
                            and the counter; ``monotile``, its binding
                            included; on the CPU their plain versions);
                            attributes ``kernel``, ``pass_index``; a tile
                            pass's also ``halo``, its window's halo a side
                            (``tile_pass.pass_halo``), and on the card
                            ``map``
``kernels.enqueue``         inside ``kernels.launch``, the ``ctypes`` call of
                            the C launcher alone (CUDA tensors only)
``entry.sync``              the final synchronize of a blocking call
``models.step``             one timestep of convection's ``Simulation.step``
                            (``models/convection.py``): its convergence loop,
                            ``dt`` and thermal step. It and the three below
                            open outside any user call, so they belong to
                            none, and the updates inside them open their own
``models.block``            inside ``models.step``, one convergence block: the
                            lean update and the full one
``models.check``            inside ``models.step``, after each block: the five
                            masked maxima and their readback to the host
                            (``_error_maxes``)
``models.readback``         inside ``models.check``, the blocking transfer of
                            the maxima to the host alone
``models.thermal``          inside ``models.step``: the adaptive ``dt``, written
                            into the thermal update, and that update
==========================  ==================================================

Spans are off by default. :func:`enable` turns them on, :func:`disable` off,
and :func:`collect` returns the spans recorded so far and forgets them; they
stay in memory until then. Collect between calls: a span still open keeps its
place in the list collected before. Spans nest by one stack, so they describe
the calls of one thread.

A call site checks the flag :data:`on` once and, when it is false, enters the
shared no-op context :data:`OFF`: no clock read, no allocation::

    with tracing.span("kernels.launch", kernel="tile_pass") if tracing.on else tracing.OFF:
        ...

Times are :data:`clock` readings, ``time.perf_counter_ns``. :func:`enable`
takes an anchor pair of that clock and ``time.time_ns``, and
:func:`to_unix_ns` puts a reading on Unix-epoch nanoseconds: the timeline of
``torch.profiler``'s host events, ``prof.profiler.kineto_results.
trace_start_ns() + event.time_range.start * 1000``, and of a Chrome trace's
events, ``baseTimeNanoseconds + ts * 1000``. Spans are not mirrored into
``torch.profiler``: a profiled call costs what it cost before.
``bench.profile.trace`` writes them into its Chrome trace beside the kernels.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any

__all__ = ["OFF", "Span", "call", "clock", "collect", "disable", "enable", "on", "span", "to_unix_ns"]

#: Whether spans are recorded; every call site checks it once.
on = False
#: The clock spans read, in nanoseconds.
clock = time.perf_counter_ns
#: The context a call site enters when spans are off.
OFF = contextlib.nullcontext()

CALL = "entry.call"

_spans: list[Span] = []
_open: list[Span] = []
_calls = 0
#: ``(time.time_ns(), clock())`` read together at :func:`enable`.
_anchor = (0, 0)


class Span:
    """One span: ``name``, ``start_ns`` and ``end_ns`` on :data:`clock`, the
    index of its ``parent`` in the list :func:`collect` returns (``None`` at
    the top), the id of the user ``call`` it belongs to (``None`` outside
    one) and ``attrs``, a few small attributes. A context manager: entering
    starts it, leaving ends it."""

    __slots__ = ("name", "attrs", "start_ns", "end_ns", "parent", "call", "index")

    def __init__(self, name: str, attrs: dict, call_id: int | None = None):
        self.name, self.attrs, self.call = name, attrs, call_id
        self.start_ns = self.end_ns = 0
        self.parent = None
        self.index = -1

    def __enter__(self) -> Span:
        if _open:
            outer = _open[-1]
            self.parent = outer.index
            if self.call is None:
                self.call = outer.call
        self.index = len(_spans)
        _spans.append(self)
        _open.append(self)
        self.start_ns = clock()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = clock()
        _open.pop()


def span(name: str, **attrs: Any) -> Span:
    """A span of ``name``, to enter with ``with``."""
    return Span(name, attrs)


def call(updater: Any, grid: Any) -> Span | contextlib.nullcontext:
    """The ``entry.call`` span of ``updater(grid)`` with a new call id, or
    :data:`OFF` inside an open call (a delegate's call is its caller's)."""
    global _calls
    if _open and _open[-1].call is not None:
        return OFF
    _calls += 1
    backend = type(updater).__module__.rpartition(".")[2]
    attrs = {"backend": backend, "H": grid.height, "W": grid.width, "n": int(updater.params.n_iterations)}
    return Span(CALL, attrs, _calls)


def enable() -> None:
    """Record spans from now on, and take the anchor of :func:`to_unix_ns`."""
    global on, _anchor
    before = clock()
    unix = time.time_ns()
    _anchor = (unix, (before + clock()) // 2)
    on = True


def disable() -> None:
    """Record no more spans; those recorded stay until :func:`collect`."""
    global on
    on = False


def collect() -> list[Span]:
    """The spans recorded since the last collect, in the order they opened;
    forgets them."""
    global _spans
    out, _spans = _spans, []
    return out


def to_unix_ns(t_ns: int) -> int:
    """A :data:`clock` reading in Unix-epoch nanoseconds, the profiler's
    host timeline, by the anchor the last :func:`enable` took."""
    return t_ns - _anchor[1] + _anchor[0]
