"""Array-backend dispatch: numpy on host, jax.numpy inside jit traces.

The execution model splits the framework in two planes:

- the **host plane** (context setup, key generation, encode/encrypt/decrypt,
  the eager SEAL-style Evaluator API) runs exact u64 math in numpy — no
  device round trips, no per-op XLA compiles;
- the **device plane** (the jitted pipelines in models/, the sharded
  multi-chip paths) traces the very same op functions with jax tracers,
  which this dispatcher routes to jax.numpy so they compile into one fused
  XLA program.

Every op in gemini_seal.ops is written once against this dispatcher.
numpy and jax.numpy agree on the full API surface used here (where, stack,
take, pad, concatenate, uint64 casts); semantics are identical because all
kernels are deterministic integer arithmetic mod 2^64.
"""

from __future__ import annotations

import numpy as np

__all__ = ["xp", "is_device_array", "set_at"]


def is_device_array(a) -> bool:
    """True for jax arrays and tracers (anything that must stay on-device)."""
    mod = type(a).__module__
    return mod.startswith("jax") or mod.startswith("jaxlib")


def xp(*arrays):
    """Pick the array module: jax.numpy if any input is a jax array/tracer,
    else numpy."""
    for a in arrays:
        if is_device_array(a):
            import jax.numpy as jnp

            return jnp
    return np


def set_at(arr, idx, value):
    """arr with arr[idx] = value, functional on both backends."""
    if is_device_array(arr):
        return arr.at[idx].set(value)
    out = np.array(arr, copy=True)
    out[idx] = value
    return out
