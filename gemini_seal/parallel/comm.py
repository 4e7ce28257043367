"""Interconnect communication accounting from compiled HLO.

GSPMD's partitioned HLO names every inter-device collective with its full
result shape.  This module parses those ops out of ``jit(...).lower(...).compile().as_text()``
and turns them into

- hard test guards against *silent de-parallelization* (XLA is always free
  to satisfy a sharding by all-gathering an axis and computing replicated;
  bit-exactness tests cannot see the difference, these can), and
- per-step interconnect byte counts (tools/comm_table.py,
  ``chip_smoke.py --four-cards``).

No reference analogue (the reference is single-process; SURVEY §2.4).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional

__all__ = ["CollectiveStats", "collective_stats", "assert_collectives"]

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
}

_COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "collective-permute",
    "all-to-all",
)

# `%name = u64[4,6,64]{2,1,0} all-reduce(...)` or, for tuple results,
# `%name = (u64[..]{..}, u64[..]{..}) all-to-all(...)`
_OP_RE = re.compile(
    r"=\s*(\(?[^=]*?)\s*(" + "|".join(_COLLECTIVES) + r")(?:-start|-done)?\("
)
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 8)


@dataclass
class CollectiveStats:
    """Per-kind counts and result-bytes of the collectives in one program."""

    count: Dict[str, int] = field(default_factory=dict)
    bytes: Dict[str, int] = field(default_factory=dict)
    max_bytes: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes.values())

    def __str__(self) -> str:
        rows = [
            f"{k}: count={self.count[k]} bytes={self.bytes[k]}"
            for k in sorted(self.count)
        ]
        return "; ".join(rows) if rows else "no collectives"


def collective_stats(hlo_text: str) -> CollectiveStats:
    """Parse compiled HLO text into per-collective counts and byte volumes.

    Bytes are the op's RESULT footprint (per participating device) — the
    standard proxy for interconnect traffic per link direction.
    `-start`/`-done`
    async pairs count once (on `-start`; `-done` lines carry no new shape).
    """
    stats = CollectiveStats()
    seen_async: set = set()
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if m is None:
            continue
        if f"{m.group(2)}-done(" in line:
            continue
        # async ops appear as `op-start` + later `op-done`; via the regex the
        # `-start` line still matches with group(2) = base name.
        kind = m.group(2)
        shapes = _SHAPE_RE.findall(m.group(1))
        if not shapes:
            continue
        if f"{kind}-start(" in line and len(shapes) > 1:
            # async ops return a tuple (operand, result[, context scalars]);
            # count only the RESULT buffer — the documented semantics.
            # Strip trailing u32/s32 context scalars, then take the last.
            while len(shapes) > 1 and shapes[-1][0] in ("u32", "s32") and (
                not shapes[-1][1] or _shape_bytes(*shapes[-1]) <= 8
            ):
                shapes = shapes[:-1]
            shapes = shapes[-1:]
        nbytes = sum(_shape_bytes(dt, dims) for dt, dims in shapes)
        stats.count[kind] = stats.count.get(kind, 0) + 1
        stats.bytes[kind] = stats.bytes.get(kind, 0) + nbytes
        stats.max_bytes[kind] = max(stats.max_bytes.get(kind, 0), nbytes)
    return stats


def assert_collectives(
    hlo_text: str,
    require_any: Iterable[str] = (),
    forbid: Iterable[str] = (),
    max_allgather_bytes: Optional[int] = None,
) -> CollectiveStats:
    """Guard a compiled program's collective profile.

    require_any: at least one collective of one of these kinds must appear
      (the program really is distributed);
    forbid: kinds that must NOT appear;
    max_allgather_bytes: largest permissible single all-gather result — set
      this below the full working tensor's footprint to prove XLA did not
      de-parallelize by replicating the sharded axis.
    """
    stats = collective_stats(hlo_text)
    req = list(require_any)
    if req and not any(k in stats.count for k in req):
        raise AssertionError(
            f"expected one of {req} in compiled HLO, found: {stats}"
        )
    for k in forbid:
        if k in stats.count:
            raise AssertionError(f"forbidden collective {k} present: {stats}")
    if max_allgather_bytes is not None:
        got = stats.max_bytes.get("all-gather", 0)
        if got > max_allgather_bytes:
            raise AssertionError(
                f"all-gather of {got} bytes exceeds the de-parallelization "
                f"bound {max_allgather_bytes} (XLA replicated a sharded axis)"
            )
    return stats
