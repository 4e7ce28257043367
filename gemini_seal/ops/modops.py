"""Device-side 64-bit modular arithmetic (JAX/XLA).

The scalar kernel layer of the framework — the JAX equivalent of the
reference's Barrett/Shoup single-word modmul library
(reference: native/src/seal/util/uintarithsmallmod.h:140-323,
util/uintarith.h:802-975).

Everything operates on ``uint64`` jnp arrays.  GPUs have no 64-bit integer
multiplier; XLA lowers u64 ops onto 32-bit operations, and the wide
(128-bit) products needed by Barrett reduction are built here explicitly
from 32-bit halves, so every product is plain XLA with no intrinsic.  All
functions are shape-polymorphic: modulus-side constants broadcast against the
data operand (callers pass them shaped ``[L, 1]`` against data ``[..., L, N]``).

Value-range contracts ("lazy" bounds) follow the reference exactly so that
kernel compositions (NTT -> dyadic -> base conversion) stay overflow-free:
  - mul_mod_shoup_lazy: output in [0, 2p) for any 64-bit x, w < p
  - barrett_reduce_128/64: output in [0, p)
"""

from __future__ import annotations

import numpy as np

from .backend import xp

__all__ = [
    "mul64_wide",
    "mulhi64",
    "add128",
    "barrett_reduce_128",
    "barrett_reduce_64",
    "mul_mod",
    "mul_mod_shoup_lazy",
    "mul_mod_shoup",
    "add_mod",
    "sub_mod",
    "neg_mod",
    "reduce_once",
    "reduce_twice",
    "accumulate_mulmod_128",
]

# numpy scalars: no JAX backend initialization at import time
_MASK32 = np.uint64(0xFFFFFFFF)
_U32 = np.uint64(32)

# Trace-time 64x64->128 MAC counter (see ops/ntt.TRACE_COUNTS): when set to
# a list, accumulate_mulmod_128 appends the broadcast element count of each
# partial product it accumulates.  Drives the contraction term of the
# per-config floor model (tools/floor_model.py).
TRACE_MACS = None


def _u64(x, m=None):
    m = m or xp(x)
    return m.asarray(x, dtype=m.uint64)


def mul64_wide(a, b):
    """Full 64x64 -> 128-bit product as (hi, lo) uint64 pair.

    Reference analogue: multiply_uint64 (util/uintarith.h:802).
    """
    m = xp(a, b)
    a = _u64(a, m)
    b = _u64(b, m)
    a_lo = a & _MASK32
    a_hi = a >> _U32
    b_lo = b & _MASK32
    b_hi = b >> _U32
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    # mid <= (2^32-1) + 2*(2^32-1)... < 2^34: fits u64 exactly.
    mid = (ll >> _U32) + (lh & _MASK32) + (hl & _MASK32)
    lo = (mid << _U32) | (ll & _MASK32)
    hi = hh + (lh >> _U32) + (hl >> _U32) + (mid >> _U32)
    return hi, lo


def mulhi64(a, b):
    """High 64 bits of the 128-bit product (util/uintarith.h:832)."""
    return mul64_wide(a, b)[0]


def add128(hi_a, lo_a, hi_b, lo_b):
    """(hi_a:lo_a) + (hi_b:lo_b) mod 2^128 as (hi, lo)."""
    m = xp(hi_a, lo_a, hi_b, lo_b)
    lo = lo_a + lo_b
    carry = (lo < lo_a).astype(m.uint64)
    return hi_a + hi_b + carry, lo


def barrett_reduce_128(hi, lo, p, ratio0, ratio1):
    """[0, 2^128) -> [0, p) Barrett reduction.

    Exact port of the reference algorithm (uintarithsmallmod.h:140-178):
    approximates q = floor(x * floor(2^128/p) / 2^128) and corrects once.
    ratio0/ratio1 are the low/high words of floor(2^128/p).
    """
    m = xp(hi, lo, p, ratio0, ratio1)
    hi, lo = _u64(hi, m), _u64(lo, m)
    p = _u64(p, m)
    ratio0 = _u64(ratio0, m)
    ratio1 = _u64(ratio1, m)

    carry = mulhi64(lo, ratio0)
    t2_hi, t2_lo = mul64_wide(lo, ratio1)
    tmp1 = t2_lo + carry
    c1 = (tmp1 < t2_lo).astype(m.uint64)
    tmp3 = t2_hi + c1
    t2_hi, t2_lo = mul64_wide(hi, ratio0)
    tmp1b = tmp1 + t2_lo
    c2 = (tmp1b < tmp1).astype(m.uint64)
    carry2 = t2_hi + c2
    tmp1c = hi * ratio1 + tmp3 + carry2
    result = lo - tmp1c * p
    return m.where(result >= p, result - p, result)


def divmod_128(hi, lo, p, ratio0, ratio1):
    """floor((hi:lo) / p) and remainder, quotient must fit in 64 bits.

    Same Barrett approximation as barrett_reduce_128 with the quotient
    corrected and returned (used by BFV plain scaling,
    reference: scalingvariant.cpp:40-44 divide_uint128_inplace).
    """
    m = xp(hi, lo, p, ratio0, ratio1)
    hi, lo = _u64(hi, m), _u64(lo, m)
    p = _u64(p, m)
    ratio0 = _u64(ratio0, m)
    ratio1 = _u64(ratio1, m)

    carry = mulhi64(lo, ratio0)
    t2_hi, t2_lo = mul64_wide(lo, ratio1)
    tmp1 = t2_lo + carry
    c1 = (tmp1 < t2_lo).astype(m.uint64)
    tmp3 = t2_hi + c1
    t2_hi, t2_lo = mul64_wide(hi, ratio0)
    tmp1b = tmp1 + t2_lo
    c2 = (tmp1b < tmp1).astype(m.uint64)
    carry2 = t2_hi + c2
    q = hi * ratio1 + tmp3 + carry2
    r = lo - q * p
    fix = (r >= p).astype(m.uint64)
    return q + fix, m.where(r >= p, r - p, r)


def barrett_reduce_64(x, p, ratio1):
    """[0, 2^64) -> [0, p) single-word Barrett reduction.

    Reference: barrett_reduce_63 generalised — using only the high ratio word
    gives q within 1 of the true quotient for any 64-bit input, corrected by
    one conditional subtract... the reference restricts inputs to 63 bits
    (uintarithsmallmod.h:181-207); we keep the same contract.
    """
    m = xp(x, p, ratio1)
    x = _u64(x, m)
    p = _u64(p, m)
    q = mulhi64(x, ratio1)
    result = x - q * p
    return m.where(result >= p, result - p, result)


def mul_mod(a, b, p, ratio0, ratio1):
    """a * b mod p via Barrett (uintarithsmallmod.h:209-221)."""
    hi, lo = mul64_wide(a, b)
    return barrett_reduce_128(hi, lo, p, ratio0, ratio1)


def mul_mod_shoup_lazy(x, w, w_shoup, p):
    """x * w mod p in [0, 2p) given w_shoup = floor(w * 2^64 / p).

    Harvey/Shoup lazy multiplication (reference: ntt.cpp:230-234,
    multi_special_primes.cpp:2-20).  Valid for any 64-bit x and w < p.
    """
    m = xp(x, w, w_shoup, p)
    x = _u64(x, m)
    q = mulhi64(x, w_shoup)
    return x * _u64(w, m) - q * _u64(p, m)


def mul_mod_shoup(x, w, w_shoup, p):
    """Canonical-output Shoup multiplication: [0, p)."""
    m = xp(x, w, w_shoup, p)
    r = mul_mod_shoup_lazy(x, w, w_shoup, p)
    p = _u64(p, m)
    return m.where(r >= p, r - p, r)


def add_mod(a, b, p):
    """(a + b) mod p for a, b in [0, p) (polyarithsmallmod.h add)."""
    m = xp(a, b, p)
    s = _u64(a, m) + _u64(b, m)
    p = _u64(p, m)
    return m.where(s >= p, s - p, s)


def sub_mod(a, b, p):
    """(a - b) mod p for a, b in [0, p)."""
    m = xp(a, b, p)
    a = _u64(a, m)
    b = _u64(b, m)
    p = _u64(p, m)
    d = a - b
    return m.where(a < b, d + p, d)


def neg_mod(a, p):
    """(-a) mod p for a in [0, p) (polyarithsmallmod.h:176-259)."""
    m = xp(a, p)
    a = _u64(a, m)
    p = _u64(p, m)
    return m.where(a == 0, a, p - a)


def accumulate_mulmod_128(pairs, p, ratio0, ratio1):
    """sum_k a_k * b_k mod p with exact 128-bit accumulation.

    The vectorized equivalent of the reference's FMAU128 lazy accumulator
    (multi_special_primes.cpp:2-20) + barrett_reduce_128: each 128-bit
    partial product is split into four 32-bit digit planes summed in u64
    (safe for <= 2^26 terms of any-range u64 inputs, i.e. lazy [0, 4p)
    operands included when the caller's margin allows — see
    KeySwitchPlan.lazy_digits), then renormalized once and Barrett-reduced.

    `pairs` is an iterable of (a, b) broadcastable u64 operands; this is
    THE accumulation kernel for the key-switch inner product, the mod-up
    contraction, and base conversion (ops/rnsops._dot_mod_128).
    """
    l0 = l1 = l2 = l3 = None
    for a, b in pairs:
        if TRACE_MACS is not None:
            cnt = 1
            for d in np.broadcast_shapes(np.shape(a), np.shape(b)):
                cnt *= int(d)
            TRACE_MACS.append(cnt)
        hi, lo = mul64_wide(a, b)
        if l0 is None:
            l0, l1 = (lo & _MASK32), (lo >> _U32)
            l2, l3 = (hi & _MASK32), (hi >> _U32)
        else:
            l0 = l0 + (lo & _MASK32)
            l1 = l1 + (lo >> _U32)
            l2 = l2 + (hi & _MASK32)
            l3 = l3 + (hi >> _U32)
    s1 = l1 + (l0 >> _U32)
    s2 = l2 + (s1 >> _U32)
    s3 = l3 + (s2 >> _U32)
    return barrett_reduce_128(
        (s2 & _MASK32) | (s3 << _U32), (l0 & _MASK32) | (s1 << _U32),
        p, ratio0, ratio1,
    )


def reduce_once(x, p):
    """[0, 2p) -> [0, p)."""
    m = xp(x, p)
    x = _u64(x, m)
    p = _u64(p, m)
    return m.where(x >= p, x - p, x)


def reduce_twice(x, p):
    """[0, 4p) -> [0, p)."""
    return reduce_once(reduce_once(x, _u64(p, xp(x, p)) * np.uint64(2)), p)
