"""Negacyclic NTT: host table precompute + device transform (JAX/XLA).

JAX rework of the fork's rewritten NTT kernel
(reference: native/src/seal/util/ntt.{h,cpp}).  The table layout is
bit-identical to the reference's ``NTTTables``:

- ``root_powers``: powers of the minimal primitive 2N-th root psi in
  bit-scrambled order (ntt.cpp:101-111); entry m+i drives stage m.
- ``scaled_root_powers``: Shoup duals floor(w * 2^64 / p) (ntt.cpp:113-119).
- ``inv_root_powers``: psi^{-1} powers, *reordered for sequential access*
  (stage m = n/2 first), with n^{-1} merged into the last entry
  (ntt.cpp:85-98).
- ``reduce_precomp``: floor(2^64 / p) (ntt.h:176).

The device transform reproduces the SlothfulNTT lazy dataflow
(ntt.cpp:213-282): Shoup butterflies, forward output lazy in [0, 4p),
inverse output lazy in [0, 2p).  The forward accumulating lane gets a
conditional subtract keeping it in [0, 2p) (the upstream Harvey butterfly
— see the inline note about the fork's 60-bit overflow), so every
intermediate stays below 2^64 for moduli up to 61 bits.  Instead of the
reference's pointer-walking scalar loops, ``FUSE_STAGES`` butterfly
stages are computed per materialization in one radix-2^k view
``[..., L, m, 2^k, h]`` whose lanes are held as separate arrays between
sub-stages — XLA fuses the whole k-stage elementwise chain and only the
final stack+reshape touches device memory, with the EXACT radix-2 butterfly
sequence (bit-identical outputs for any k).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from ..utils import numth
from ..utils import native as _native
from .backend import xp
from ..modulus import Modulus
from . import modops

__all__ = ["NTTTables", "build_ntt_tables", "ntt_forward", "ntt_inverse",
           "ntt_forward_lazy", "ntt_inverse_lazy", "fuse_depth"]

U64 = 0xFFFFFFFFFFFFFFFF

# Butterfly stages fused per materialization on the device path: k stages
# are computed in one radix-2^k view of the SAME radix-2 arithmetic —
# bit-identical outputs for any k, 1/k the per-stage round trips through
# device memory.  1 = classic per-stage radix-2.  The depth follows the
# platform the transform is traced for (``fuse_depth``): k=3 won the
# bench.py headline step on an H100 (+7.6 % over k=2;
# tools/bench_ntt_fused.py, PERF.md has the sweep), while on the CPU
# backend, where the test suite runs, k=3 compiles 1.7x slower than k=2.
#
# None selects by platform; an int overrides it for every platform.
# TRACE-TIME semantics: this global is read when a transform is TRACED.
# Reassigning it later has no effect on already-jitted pipelines (their
# compiled executables are baked); set it before building/jitting, as
# tools/bench_ntt_fused.py and tests/test_ntt.py do (under try/finally).
FUSE_STAGES = None

# Trace-time transform counter for the per-config floor model
# (tools/floor_model.py): when set to a list, every transform call appends
# ("fwd"|"inv", rows, N) with rows = prod(all leading dims) — under
# jax.eval_shape tracing this counts exactly the poly-limb NTT rows the
# compiled program will execute.  None (default) costs nothing.
# CAVEAT: JAX caches traces per (function object, avals) — a pipeline that
# was already jit-executed or eval_shape'd will NOT re-trace, so enable
# the counter and eval_shape a FRESHLY BUILT pipeline (what floor_model
# does; pinned in tests/test_modops.py::test_trace_counters).
TRACE_COUNTS = None


def fuse_depth(x) -> int:
    """Butterfly stages per materialization for transforming ``x``."""
    if FUSE_STAGES is not None:
        return max(int(FUSE_STAGES), 1)
    if isinstance(x, np.ndarray):   # host plane: never touch a device
        return 2
    import jax

    return 3 if jax.default_backend() == "gpu" else 2


def _count_rows(kind, x):
    if TRACE_COUNTS is not None:
        rows = 1
        for d in x.shape[:-1]:
            rows *= int(d)
        TRACE_COUNTS.append((kind, rows, int(x.shape[-1])))


def _shoupify(x: int, p: int) -> int:
    """floor(x * 2^64 / p) (reference: ntt.cpp:18-24)."""
    return ((x << 64) // p) & U64


@dataclass
class NTTTables:
    """Per-modulus-set NTT tables, stacked over the limb axis.

    All arrays are uint64 with shape [L, N] (per-limb scalars are [L]).
    Host-built with exact integers; moved to device lazily by the context.
    """

    coeff_count_power: int
    coeff_count: int
    moduli: List[int]
    roots: np.ndarray                 # [L] minimal primitive 2N-th roots
    root_powers: np.ndarray           # [L, N]
    scaled_root_powers: np.ndarray    # [L, N]
    inv_root_powers: np.ndarray       # [L, N] (reordered, n^-1 merged)
    scaled_inv_root_powers: np.ndarray
    inv_degree_modulo: np.ndarray     # [L]
    scaled_inv_degree: np.ndarray     # [L]
    reduce_precomp: np.ndarray        # [L] floor(2^64/p)
    modulus: np.ndarray               # [L]

    @property
    def n(self) -> int:
        return self.coeff_count


def _powers_of_root_bit_scrambled(root: int, n: int, log_n: int, p: int) -> np.ndarray:
    """Powers of `root` laid out in bit-reversed order (ntt.cpp:101-111).

    destination[reverse_bits(i)] = root^i, built by the reference's chained
    walk: each step multiplies the previously-written value.
    """
    out = np.zeros(n, dtype=np.uint64)
    out[0] = 1
    prev = 1
    for i in range(1, n):
        idx = numth.reverse_bits(i, log_n)
        prev = (prev * root) % p
        out[idx] = prev
    return out


# Per-(n, modulus) single-row table cache: the modulus-switching chain reuses
# the same moduli at every level, so each prime's tables are built once.
_TABLE_CACHE: dict = {}


def _build_single(coeff_count_power: int, p: int):
    key = (coeff_count_power, p)
    hit = _TABLE_CACHE.get(key)
    if hit is not None:
        return hit
    n = 1 << coeff_count_power

    root = numth.try_minimal_primitive_root(2 * n, p)
    if root is None:
        raise ValueError(f"modulus {p:#x} does not support NTT of size {n}")
    inv_root = numth.try_invert_uint_mod(root, p)
    inv_n = numth.try_invert_uint_mod(n, p)
    if inv_root is None or inv_n is None:
        raise ValueError("invalid modulus")

    fwd = _powers_of_root_bit_scrambled(root, n, coeff_count_power, p)
    scaled_fwd = np.array([_shoupify(int(w), p) for w in fwd], dtype=np.uint64)

    inv = _powers_of_root_bit_scrambled(inv_root, n, coeff_count_power, p)
    # Reorder for sequential inverse access (ntt.cpp:85-95): walk stages
    # m = n/2 down to 1, emitting entries [m, 2m).
    reordered = np.zeros(n, dtype=np.uint64)
    pos = 1
    m = n >> 1
    while m > 0:
        reordered[pos : pos + m] = inv[m : 2 * m]
        pos += m
        m >>= 1
    # Merge n^{-1} into the last entry (ntt.cpp:96-98).
    reordered[n - 1] = (int(reordered[n - 1]) * inv_n) % p
    scaled_inv = np.array([_shoupify(int(w), p) for w in reordered], dtype=np.uint64)

    entry = (root, fwd, scaled_fwd, reordered, scaled_inv, inv_n,
             _shoupify(inv_n, p), _shoupify(1, p))
    _TABLE_CACHE[key] = entry
    return entry


def build_ntt_tables(coeff_count_power: int, moduli: Sequence) -> NTTTables:
    """Build NTT tables for each modulus, matching NTTTables::initialize
    (reference: ntt.cpp:37-99) bit-for-bit."""
    n = 1 << coeff_count_power
    mods = [m.value if isinstance(m, Modulus) else int(m) for m in moduli]
    L = len(mods)

    roots = np.zeros(L, dtype=np.uint64)
    root_powers = np.zeros((L, n), dtype=np.uint64)
    scaled_root_powers = np.zeros((L, n), dtype=np.uint64)
    inv_root_powers = np.zeros((L, n), dtype=np.uint64)
    scaled_inv_root_powers = np.zeros((L, n), dtype=np.uint64)
    inv_degree = np.zeros(L, dtype=np.uint64)
    scaled_inv_degree = np.zeros(L, dtype=np.uint64)
    reduce_precomp = np.zeros(L, dtype=np.uint64)

    for j, p in enumerate(mods):
        (root, fwd, scaled_fwd, inv_reord, scaled_inv, inv_n, inv_n_s, rdp) = (
            _build_single(coeff_count_power, p)
        )
        roots[j] = root
        root_powers[j] = fwd
        scaled_root_powers[j] = scaled_fwd
        inv_root_powers[j] = inv_reord
        scaled_inv_root_powers[j] = scaled_inv
        inv_degree[j] = inv_n
        scaled_inv_degree[j] = inv_n_s
        reduce_precomp[j] = rdp

    return NTTTables(
        coeff_count_power=coeff_count_power,
        coeff_count=n,
        moduli=mods,
        roots=roots,
        root_powers=root_powers,
        scaled_root_powers=scaled_root_powers,
        inv_root_powers=inv_root_powers,
        scaled_inv_root_powers=scaled_inv_root_powers,
        inv_degree_modulo=inv_degree,
        scaled_inv_degree=scaled_inv_degree,
        reduce_precomp=reduce_precomp,
        modulus=np.array(mods, dtype=np.uint64),
    )


def _as_u64(v):
    """Pass traced/device arrays through untouched (the sharded schedules
    feed dynamically-sliced table rows); coerce host values to u64."""
    if isinstance(v, (np.ndarray, list, tuple, int, np.integer)):
        return np.asarray(v, dtype=np.uint64)
    return v


def _expand(v, extra_dims: int):
    """[L] or [L, m] constant -> broadcastable against [..., L, m, h]."""
    v = _as_u64(v)
    return v.reshape(v.shape + (1,) * extra_dims)


def _host_fast(x, tables):
    """True when the call is host-plane (numpy in, numpy tables) and the
    native transform is available — the object layer's encode/decode/
    decrypt path, where numpy's per-stage passes cost ~10x the C++ loop."""
    return (
        isinstance(x, np.ndarray)
        and isinstance(tables.root_powers, np.ndarray)
        and _native.available()
    )


def ntt_forward_lazy(x, tables):
    """Forward negacyclic NTT over the last axis; output lazy in [0, 4p).

    x: uint64[..., L, N]; tables: NTTTables (or its device mirror).
    Mirrors ntt_negacyclic_harvey_lazy (reference: ntt.cpp:292-342).
    """
    _count_rows("fwd", x)
    if _host_fast(x, tables):
        return _native.ntt_forward(
            x, tables.root_powers, tables.scaled_root_powers, tables.modulus,
            canonical=False,
        )
    n = tables.coeff_count
    log_n = tables.coeff_count_power
    batch = x.shape[:-1]
    L = x.shape[-2]
    m_ = xp(x)
    p = _expand(tables.modulus, 2)        # [L,1,1]
    two_p = p * np.uint64(2)
    w_all = _as_u64(tables.root_powers)
    ws_all = _as_u64(tables.scaled_root_powers)

    depth = fuse_depth(x)
    s = 0
    while s < log_n:
        # k stages in one radix-2^k view: the lanes stay as separate arrays
        # between sub-stages (XLA fuses the elementwise chains), so only the
        # final stack+reshape materializes — 1/k the stage round trips.
        # The butterfly/reduction sequence is EXACTLY the per-stage radix-2
        # one, so the output is bit-identical for any k.
        k = min(depth, log_n - s)
        m = 1 << s
        R = 1 << k
        h = n >> (s + k)
        xr = x.reshape(batch[:-1] + (L, m, R, h))
        lanes = [xr[..., j, :] for j in range(R)]
        for t in range(k):
            G = R >> t            # lanes per stage-(s+t) block
            half = G >> 1
            n_blk = 1 << t        # stage-(s+t) blocks per outer block
            mt = m << t
            # reshape(-1, ...) derives the leading dim from the table, so a
            # broadcastable size-1 table row works as well as an exact L.
            w_t = w_all[:, mt : 2 * mt].reshape(-1, m, n_blk)
            ws_t = ws_all[:, mt : 2 * mt].reshape(-1, m, n_blk)
            new = [None] * R
            for b in range(n_blk):
                w = w_t[:, :, b : b + 1]     # [L, m, 1]
                ws = ws_t[:, :, b : b + 1]
                for u in range(half):
                    j0 = b * G + u
                    j1 = j0 + half
                    x0 = lanes[j0]
                    # Keep the accumulating lane in [0, 2p) with a
                    # conditional subtract (upstream Harvey butterfly).
                    # The fork's SlothfulNTT::ForwardLazy omits this and
                    # overflows u64 for 60-bit moduli at N >= 2048 — e.g.
                    # its own 60-bit Bsk base-conversion primes; we keep
                    # the overflow-free contract for all <= 61-bit moduli.
                    x0 = m_.where(x0 >= two_p, x0 - two_p, x0)
                    v = modops.mul_mod_shoup_lazy(lanes[j1], w, ws, p)
                    new[j0] = x0 + v
                    new[j1] = x0 - v + two_p
            lanes = new
        x = m_.stack(lanes, axis=-2).reshape(batch + (n,))
        s += k
    return x


def ntt_forward(x, tables):
    """Forward NTT with canonical output in [0, p)."""
    if _host_fast(x, tables):
        return _native.ntt_forward(
            x, tables.root_powers, tables.scaled_root_powers, tables.modulus,
            canonical=True,
        )
    out = ntt_forward_lazy(x, tables)
    p = _expand(tables.modulus, 1)
    return modops.reduce_twice(out, p)


def ntt_inverse_lazy(x, tables):
    """Inverse negacyclic NTT over the last axis; output lazy in [0, 2p).

    Input must be in [0, 2p).  Mirrors inverse_ntt_negacyclic_harvey_lazy
    (reference: ntt.cpp:345-404) including the sequential reordered twiddle
    walk and the n^{-1} fold into the last butterfly layer.
    """
    _count_rows("inv", x)
    if _host_fast(x, tables):
        return _native.ntt_inverse(
            x, tables.inv_root_powers, tables.scaled_inv_root_powers,
            tables.inv_degree_modulo, tables.scaled_inv_degree,
            tables.modulus, canonical=False,
        )
    n = tables.coeff_count
    log_n = tables.coeff_count_power
    batch = x.shape[:-1]
    L = x.shape[-2]
    m_ = xp(x)
    p = _expand(tables.modulus, 2)
    two_p = p * np.uint64(2)
    w_all = _as_u64(tables.inv_root_powers)
    ws_all = _as_u64(tables.scaled_inv_root_powers)
    inv_n = _expand(tables.inv_degree_modulo, 2)
    inv_n_s = _expand(tables.scaled_inv_degree, 2)

    depth = fuse_depth(x)
    ofs = 1
    s = 0
    while s < log_n:
        # k inverse stages in one radix-2^k view (see the forward transform)
        # — identical arithmetic including the sequential reordered twiddle
        # walk and the n^{-1} fold when the block's last sub-stage is the
        # final stage, so the output is bit-identical for any k.
        k = min(depth, log_n - s)
        R = 1 << k
        M = n >> (s + k)          # outer blocks in the fused view
        h = 1 << s
        xr = x.reshape(batch[:-1] + (L, M, R, h))
        lanes = [xr[..., j, :] for j in range(R)]
        for t in range(k):
            m = n >> (s + t + 1)  # stage-(s+t) block count
            G = 1 << (t + 1)      # lanes per stage-(s+t) block
            half = G >> 1
            n_blk = R // G        # stage-(s+t) blocks per outer block
            w_t = w_all[:, ofs : ofs + m].reshape(-1, M, n_blk)
            ws_t = ws_all[:, ofs : ofs + m].reshape(-1, M, n_blk)
            ofs += m
            last = (s + t) == log_n - 1
            new = [None] * R
            for b in range(n_blk):
                w = w_t[:, :, b : b + 1]     # [L, M, 1]
                ws = ws_t[:, :, b : b + 1]
                for u in range(half):
                    j0 = b * G + u
                    j1 = j0 + half
                    tt = lanes[j0] + lanes[j1]
                    tt = m_.where(tt >= two_p, tt - two_p, tt)
                    d = lanes[j0] - lanes[j1] + two_p
                    if last:
                        # BackwardLazyLast (ntt.cpp:274-281): x0 *= n^{-1};
                        # the twiddle entry already carries w * n^{-1}.
                        tt = modops.mul_mod_shoup_lazy(tt, inv_n, inv_n_s, p)
                    new[j0] = tt
                    new[j1] = modops.mul_mod_shoup_lazy(d, w, ws, p)
            lanes = new
        x = m_.stack(lanes, axis=-2).reshape(batch + (n,))
        s += k
    return x


def ntt_inverse(x, tables):
    """Inverse NTT with canonical output in [0, p)."""
    if _host_fast(x, tables):
        return _native.ntt_inverse(
            x, tables.inv_root_powers, tables.scaled_inv_root_powers,
            tables.inv_degree_modulo, tables.scaled_inv_degree,
            tables.modulus, canonical=True,
        )
    out = ntt_inverse_lazy(x, tables)
    p = _expand(tables.modulus, 1)
    return modops.reduce_once(out, p)
