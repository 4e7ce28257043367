"""Device-mesh and sharding layout for HE tensors.

No analogue exists in the reference — it is a single-threaded library
(SURVEY §2.4).  The parallel axes over ciphertext tensors
``[batch, size, L, N]``:

- ``dp``   — ciphertext-batch data parallelism: independent ciphertexts on
  independent devices; every evaluator op is embarrassingly parallel.
- ``limb`` — RNS limb parallelism ("RNS-TP"): dyadic ops and per-limb NTTs
  are local; base conversion / key-switch inner products contract over the
  limb axis, which XLA GSPMD turns into all-gather/reduce-scatter
  collectives.

Shardings are expressed with jax.sharding.NamedSharding; the jitted
pipelines in models/pipelines.py accept pre-sharded inputs and let GSPMD
insert the collectives.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_he_mesh", "ciphertext_sharding", "key_sharding", "replicate"]


def make_he_mesh(
    n_devices: Optional[int] = None,
    dp: Optional[int] = None,
    limb: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a (dp, limb) mesh over the available devices.

    With only one axis size given, the other takes the remaining factor.
    Default split: largest power-of-two dp with at most half the devices
    on dp, remainder on limb.
    """
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    n = len(devices)
    if dp is None and limb is None:
        dp = 1
        while n % (dp * 2) == 0 and dp * 2 * 2 <= n:
            dp *= 2
        limb = n // dp
    elif dp is None:
        dp = n // limb
    elif limb is None:
        limb = n // dp
    if dp * limb != n:
        raise ValueError(f"dp*limb = {dp}*{limb} != n_devices = {n}")
    arr = np.asarray(devices).reshape(dp, limb)
    return Mesh(arr, axis_names=("dp", "limb"))


def ciphertext_sharding(mesh: Mesh, batched: bool = True) -> NamedSharding:
    """Sharding for ciphertext tensors.

    batched [B, size, L, N]: batch over dp, limbs over limb.
    unbatched [size, L, N]: limbs over limb only.
    """
    if batched:
        return NamedSharding(mesh, P("dp", None, "limb", None))
    return NamedSharding(mesh, P(None, "limb", None))


def key_sharding(mesh: Mesh) -> NamedSharding:
    """Key-switching keys [n_bundles, 2, L_key, N]: replicate over dp,
    shard the key limb axis over limb."""
    return NamedSharding(mesh, P(None, None, "limb", None))


def replicate(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
