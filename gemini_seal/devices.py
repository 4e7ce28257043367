"""What a measurement needs to know about the device it runs on.

Every number a benchmark prints names its device: the JAX platform, the
``device_kind`` and the device count, plus the card's name and power
limit as ``nvidia-smi`` reports them (a card set below its maximum power
runs slower under load).  A measurement that finds no GPU stops instead
of falling back to the CPU.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable, Dict, Sequence

__all__ = ["require_gpu", "card_line", "device_record", "time_calls"]


def require_gpu(backend: str, what: str = "this measurement") -> None:
    """Raise SystemExit(2) unless JAX's default backend is the GPU."""
    if backend != "gpu":
        raise SystemExit(
            f"{what} needs a GPU; JAX's default backend is {backend!r}")


def card_line() -> str:
    """``name, power.limit`` of every card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def device_record(devices: Sequence) -> Dict[str, object]:
    """The device as JAX reports it: platform, kind and count."""
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def time_calls(fn: Callable, args: Sequence, min_seconds: float = 2.0,
               max_iters: int = 1000) -> float:
    """Steady-state seconds per ``fn(*args)``, each call ended by
    ``block_until_ready`` on its real output.

    One untimed call warms up (and compiles); a short probe sizes the
    timed window to about ``min_seconds``.
    """
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    per = time.perf_counter() - t0
    iters = max(3, min(max_iters, int(min_seconds / max(per, 1e-6))))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters
