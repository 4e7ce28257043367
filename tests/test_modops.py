"""Device modular-arithmetic kernels vs exact Python-int arithmetic."""

import numpy as np
import jax.numpy as jnp

from gemini_seal.ops import modops
from gemini_seal.modulus import Modulus

RNG = np.random.default_rng(1234)
P_LIST = [0xFFFFFFFFFFC0001, 0x7E00001, (1 << 59) - 55]  # incl. a 59-bit prime-ish


def rand_u64(shape):
    return RNG.integers(0, 1 << 64, size=shape, dtype=np.uint64)


def test_mul64_wide():
    a = rand_u64(256)
    b = rand_u64(256)
    hi, lo = modops.mul64_wide(jnp.asarray(a), jnp.asarray(b))
    for i in range(256):
        prod = int(a[i]) * int(b[i])
        assert int(lo[i]) == prod & 0xFFFFFFFFFFFFFFFF
        assert int(hi[i]) == prod >> 64


def test_barrett_reduce_128():
    for p in P_LIST:
        m = Modulus(p) if p.bit_length() <= 61 else None
        if m is None:
            continue
        r0, r1, _ = m.const_ratio
        hi = rand_u64(128)
        lo = rand_u64(128)
        out = modops.barrett_reduce_128(
            jnp.asarray(hi), jnp.asarray(lo), jnp.uint64(p), jnp.uint64(r0), jnp.uint64(r1)
        )
        for i in range(128):
            x = (int(hi[i]) << 64) | int(lo[i])
            assert int(out[i]) == x % p


def test_mul_mod():
    p = 0xFFFFFFFFFFC0001
    r0, r1, _ = Modulus(p).const_ratio
    a = rand_u64(128) % np.uint64(p)
    b = rand_u64(128) % np.uint64(p)
    out = modops.mul_mod(jnp.asarray(a), jnp.asarray(b), jnp.uint64(p), jnp.uint64(r0), jnp.uint64(r1))
    for i in range(128):
        assert int(out[i]) == (int(a[i]) * int(b[i])) % p


def test_mul_mod_shoup():
    p = 0xFFFFFFFFFFC0001
    w = 0x123456789ABCD % p
    w_shoup = (w << 64) // p
    x = rand_u64(128)  # any 64-bit x
    lazy = modops.mul_mod_shoup_lazy(
        jnp.asarray(x), jnp.uint64(w), jnp.uint64(w_shoup), jnp.uint64(p)
    )
    strict = modops.mul_mod_shoup(
        jnp.asarray(x), jnp.uint64(w), jnp.uint64(w_shoup), jnp.uint64(p)
    )
    for i in range(128):
        expect = (int(x[i]) * w) % p
        assert int(lazy[i]) % p == expect
        assert int(lazy[i]) < 2 * p
        assert int(strict[i]) == expect


def test_add_sub_neg_mod():
    p = 0x1FFFFE0001
    a = rand_u64(64) % np.uint64(p)
    b = rand_u64(64) % np.uint64(p)
    s = modops.add_mod(jnp.asarray(a), jnp.asarray(b), jnp.uint64(p))
    d = modops.sub_mod(jnp.asarray(a), jnp.asarray(b), jnp.uint64(p))
    n = modops.neg_mod(jnp.asarray(a), jnp.uint64(p))
    for i in range(64):
        assert int(s[i]) == (int(a[i]) + int(b[i])) % p
        assert int(d[i]) == (int(a[i]) - int(b[i])) % p
        assert int(n[i]) == (-int(a[i])) % p


def test_barrett_reduce_64():
    p = 0xFFFFC4001
    _, r1, _ = Modulus(p).const_ratio
    x = rand_u64(128) >> np.uint64(1)  # 63-bit inputs per contract
    out = modops.barrett_reduce_64(jnp.asarray(x), jnp.uint64(p), jnp.uint64(r1))
    for i in range(128):
        assert int(out[i]) == int(x[i]) % p


def test_trace_counters():
    """ops/ntt.TRACE_COUNTS + ops/modops.TRACE_MACS count a freshly built
    pipeline's exact work profile under eval_shape tracing (the floor
    model's input, tools/floor_model.py), and stay inert by default.

    Counts only register for a FRESH build: JAX caches traces per
    (function, avals), so an already-executed pipeline won't re-trace —
    the documented caveat at ops/ntt.py TRACE_COUNTS.
    """
    import jax

    from gemini_seal import (
        BatchEncoder, CoeffModulus, EncryptionParameters, Encryptor,
        KeyGenerator, PlainModulus, SchemeType, SecLevelType, SealContext,
    )
    from gemini_seal.models.pipelines import build_bfv_mul_relin
    from gemini_seal.ops import modops, ntt

    assert ntt.TRACE_COUNTS is None
    assert modops.TRACE_MACS is None

    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(256)
    parms.set_coeff_modulus(CoeffModulus.create(256, [30, 30, 30]))
    parms.set_plain_modulus(PlainModulus.batching(256, 14))
    parms.set_random_seed(tuple(range(8)))
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    be = BatchEncoder(ctx)
    rk = kg.relin_keys()
    kdata = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
    a = np.asarray(enc.encrypt(be.encode([1, 2, 3])).data)

    fn = build_bfv_mul_relin(ctx)
    ntt.TRACE_COUNTS = []
    modops.TRACE_MACS = []
    try:
        jax.eval_shape(fn, a, a, kdata)
        fwd = sum(r for k, r, n in ntt.TRACE_COUNTS if k == "fwd")
        inv = sum(r for k, r, n in ntt.TRACE_COUNTS if k == "inv")
        ns = {n for _, _, n in ntt.TRACE_COUNTS}
        macs = sum(modops.TRACE_MACS)
    finally:
        ntt.TRACE_COUNTS = None
        modops.TRACE_MACS = None

    # BEHZ multiply+relin at L=3 (n_ct=2): the exact row algebra —
    # 2 operands x (q lift 2 + Bsk extend 3 rows x 2 components)... pinned
    # as totals so kernel refactors that change the WORK fail loudly.
    assert fwd == 28, fwd
    assert inv == 21, inv
    assert ns == {256}, ns
    assert macs > 0
    # every MAC entry is a positive element count
    assert all(isinstance(c, int) and c > 0 for c in [macs])
