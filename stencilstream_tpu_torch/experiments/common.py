"""What the microbenchmarks' entry points share: the device, the card's
name, pass chains timed by CUDA events, the marginal rate and the bound."""

from __future__ import annotations

import subprocess
import time
from typing import Callable

import torch

__all__ = ["HBM_BYTES_PER_S", "FP32_FLOP_PER_S", "FP64_FLOP_PER_S", "bound_ms", "card_line", "chain_seconds", "marginal",
           "ping_pong", "rate_line", "resolve_device"]

#: NVIDIA H100 SXM at 700 W (NVIDIA's data sheet): HBM3 bytes a second, and
#: float32 and float64 operations a second outside the tensor cores (a fused
#: multiply-add counts as two). The port's one table of the card's peaks:
#: ``chip_smoke.py`` takes its bounds from here too.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FP64_FLOP_PER_S = 34e12


def resolve_device(name: str) -> torch.device:
    """The device an entry point runs on: a CUDA card (the default), or the
    CPU, where only the plain versions run (for the tests). Raises when a
    CUDA device is asked for and there is none: nothing carries on on the
    CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: the microbenchmarks run their kernels on the card "
                           "(--device cpu runs the plain versions, for the tests)")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"the microbenchmarks run on a CUDA card or the CPU, not {device}")
    return device


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them; on the
    CPU a note that the numbers are the plain versions' on the host."""
    if device.type != "cuda":
        return "cpu: plain versions, host clock"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[torch.device(device).index or 0]


def chain_seconds(run: Callable[[int], object], n: int, device: torch.device) -> float:
    """Seconds of ``run(n)``, a chain of ``n`` passes: CUDA events around it
    on the card, the host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        run(n)
        return time.perf_counter() - t0
    torch.cuda.synchronize(device)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run(n)
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) / 1e3


def marginal(run: Callable[[int], object], n1: int, n2: int, device: torch.device, reps: int = 3) -> dict:
    """The scripts' timing: the first call of ``n1`` passes (build and
    warm-up), then the best of ``reps`` chains of ``n1`` and of ``n2``
    passes; the marginal time a pass ``(w2 - w1) / (n2 - n1)`` cancels the
    fixed cost of a call."""
    t0 = time.perf_counter()
    run(n1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    first = time.perf_counter() - t0
    w1 = min(chain_seconds(run, n1, device) for _ in range(reps))
    w2 = min(chain_seconds(run, n2, device) for _ in range(reps))
    return dict(first_s=first, w1=w1, w2=w2, n1=n1, n2=n2, ms=(w2 - w1) / (n2 - n1) * 1e3)


def bound_ms(n_bytes: float, n_flops: float, flop_rate: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    """The least time, in ms, the card could take: the larger of the bytes
    over HBM's rate and the operations over ``flop_rate`` (the float32
    peak unless given)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def rate_line(cells: int, steps: int, t: dict, bound: tuple[float, str], card: str) -> str:
    """The marginal GCell/s, ms a pass and share of the bound, the chains'
    times and the card."""
    gcells = cells * (t["n2"] - t["n1"]) * steps / (t["w2"] - t["w1"]) / 1e9
    b, by = bound
    return (f"{gcells:7.2f} GCell/s marginal, {t['ms']:.4f} ms a pass = {b / t['ms']:.1%} of its bound "
            f"{b:.4f} ms ({by}) (w1 {t['w1']:.3f}s/{t['n1']}, w2 {t['w2']:.3f}s/{t['n2']}, first call "
            f"{t['first_s']:.1f}s) [{card}]")


def ping_pong(step: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
              x: torch.Tensor) -> Callable[[int], torch.Tensor]:
    """A chain of passes ``step(src, dst)``, each returning its result, from
    ``x`` (not written) between two buffers: on the card a pass writes
    ``dst``; on the CPU it returns a new tensor."""
    bufs = [torch.empty_like(x), torch.empty_like(x)]

    def run(n: int) -> torch.Tensor:
        y = x
        for k in range(n):
            y = step(y, bufs[k % 2])
        return y

    return run
