"""Lazy-reduction range contracts.

The fused pipelines chain the `_lazy` NTT variants between stages: forward
output in [0, 4p), inverse output in [0, 2p), consumed ONLY by full-range
Barrett reductions (mul_mod / the 128-bit inner-product accumulation) so
results stay bit-identical to the canonical path.  These tests pin the
range contracts and the consumer-exactness property that the chaining
relies on (reference: ntt.cpp:341/403 `_lazy` + uintarithsmallmod.h
barrett_reduce_128's full-range validity).
"""

import numpy as np

from gemini_seal.modulus import CoeffModulus
from gemini_seal.ops import modops
from gemini_seal.ops.ntt import (
    build_ntt_tables,
    ntt_forward,
    ntt_forward_lazy,
    ntt_inverse,
    ntt_inverse_lazy,
)
from gemini_seal.utils.numth import get_primes


def _tables(n, bits, count=3):
    primes = get_primes(2 * n, bits, count)
    logn = n.bit_length() - 1
    return build_ntt_tables(logn, primes), np.array(primes, dtype=np.uint64)


def test_forward_lazy_range_contract():
    """ntt_forward_lazy output < 4p for every limb, at the max supported
    modulus width (61 bits — the fork's own SlothfulNTT overflows here,
    README deviation #3)."""
    rng = np.random.default_rng(7)
    for n, bits in ((256, 50), (1024, 61)):
        tables, p = _tables(n, bits)
        x = rng.integers(0, p[:, None], size=(p.size, n), dtype=np.uint64)
        out = np.asarray(ntt_forward_lazy(x, tables))
        assert np.all(out < 4 * p[:, None])
        # canonical wrapper == lazy + reduce_twice
        np.testing.assert_array_equal(
            np.asarray(ntt_forward(x, tables)),
            np.asarray(modops.reduce_twice(out, p[:, None])),
        )


def test_inverse_lazy_range_contract():
    """ntt_inverse_lazy output < 2p given input < 2p."""
    rng = np.random.default_rng(8)
    for n, bits in ((256, 50), (1024, 61)):
        tables, p = _tables(n, bits)
        x = rng.integers(0, 2 * p[:, None], size=(p.size, n), dtype=np.uint64)
        out = np.asarray(ntt_inverse_lazy(x, tables))
        assert np.all(out < 2 * p[:, None])


def test_barrett_consumers_exact_on_lazy_inputs():
    """mul_mod (the lazy values' only arithmetic consumer) reduces exactly
    from [0, 4p) x [0, 4p) — the property the chaining's bit-exactness
    rests on."""
    rng = np.random.default_rng(9)
    from gemini_seal.ops.dyadic import LimbConstants

    primes = get_primes(2048, 61, 2)
    limbs = LimbConstants.from_moduli(primes)
    p = limbs.p.reshape(-1, 1)
    a = rng.integers(0, 4 * p, size=(2, 4096), dtype=np.uint64)
    b = rng.integers(0, 4 * p, size=(2, 4096), dtype=np.uint64)
    lazy = np.asarray(modops.mul_mod(a, b, p, limbs.ratio0.reshape(-1, 1),
                                     limbs.ratio1.reshape(-1, 1)))
    canon = np.asarray(modops.mul_mod(a % p, b % p, p,
                                      limbs.ratio0.reshape(-1, 1),
                                      limbs.ratio1.reshape(-1, 1)))
    np.testing.assert_array_equal(lazy, canon)
    assert np.all(lazy < p)


def test_lazy_chained_keyswitch_bit_exact():
    """End-to-end: the lazy-chained key-switch (compute_modup_digits with
    [0,2p)/[0,4p) internal ranges) produces bit-identical switch_key output
    to a from-scratch canonical recomputation via reduced inputs."""
    from gemini_seal import (
        CKKSEncoder, Decryptor, EncryptionParameters, Encryptor, Evaluator,
        KeyGenerator, SchemeType, SecLevelType, SealContext,
    )

    parms = EncryptionParameters(SchemeType.CKKS)
    n = 256
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [40, 30, 40]))
    parms.set_random_seed(tuple(range(71, 79)))
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    ev = Evaluator(ctx)
    rk = kg.relin_keys()
    scale = 2.0 ** 30

    ct = enc.encrypt(encoder.encode([0.5, -1.0, 2.0], scale))
    out = ev.rescale_to_next(ev.relinearize(ev.multiply(ct, ct), rk))
    got = encoder.decode(dec.decrypt(out))
    for g, v in zip(got[:3], [0.5, -1.0, 2.0]):
        assert abs(g - v * v) < 1e-4


def test_lazy_digit_margin_gate():
    """The lazy [0,4p) inner-product digits shrink the 128-bit accumulator
    margin 4x vs canonical (code-review r2 finding #1).  The context layer
    already rejects >59-bit user primes (invalid_coeff_modulus_bit_count,
    matching the reference), so no CONSTRUCTIBLE context overflows — this
    pins (a) the gate predicate's boundary arithmetic, (b) lazy_digits=True
    with a healthy margin at the most extreme constructible configuration,
    and (c) that >59-bit contexts are indeed rejected upstream."""
    from gemini_seal import (
        EncryptionParameters, SchemeType, SecLevelType, SealContext,
    )
    from gemini_seal.ops.keyswitch import KeySwitchPlan

    # (a) predicate boundary: 17 bundles at 61-bit primes overflows, 16 do
    # not; canonical margin would be 4x wider
    p61 = (1 << 61) - 1
    assert not KeySwitchPlan._lazy_digits_safe(17, p61)
    assert KeySwitchPlan._lazy_digits_safe(16, p61 >> 1)
    # extreme constructible case: 63 bundles at the 59-bit user max — safe
    p59 = (1 << 59) - 1
    assert KeySwitchPlan._lazy_digits_safe(63, p59)

    # (b) a real plan at wide-ish user primes keeps the lazy fast path
    parms2 = EncryptionParameters(SchemeType.BFV)
    n = 64
    parms2.set_poly_modulus_degree(n)
    parms2.set_coeff_modulus(CoeffModulus.create(n, [59] * 6))
    parms2.set_plain_modulus(257)
    parms2.set_random_seed(tuple(range(81, 89)))
    ctx2 = SealContext(parms2, sec_level=SecLevelType.none)
    plan = KeySwitchPlan(ctx2, ctx2.first_parms_id)
    assert plan.lazy_digits

    # (c) >59-bit primes cannot form a valid context (upstream guard)
    parms3 = EncryptionParameters(SchemeType.BFV)
    parms3.set_poly_modulus_degree(n)
    parms3.set_coeff_modulus(get_primes(2 * n, 60, 18))
    parms3.set_plain_modulus(257)
    ctx3 = SealContext(parms3, sec_level=SecLevelType.none)
    assert not ctx3.parameters_set()
    assert "bit count" in str(
        ctx3.first_context_data().qualifiers.parameter_error.value
    ).lower() or "bit_count" in str(
        ctx3.first_context_data().qualifiers.parameter_error
    )
