"""Chebyshev-cosine EvalMod engine tests (models/evalmod.py).

No reference analogue (SEAL 3.5 stops at leveled CKKS).  Correctness is
pinned against numpy: the engine's homomorphic Paterson-Stockmeyer
evaluation + double-angle chain must reproduce sin(2 pi (K+1) y) on
encrypted y to the rescale-noise floor, in BOTH input conventions
(slots = y, and slots = i*y via the twisted V-basis).
"""

import math

import numpy as np
import pytest

from gemini_seal import (
    CKKSEncoder,
    CoeffModulus,
    Decryptor,
    EncryptionParameters,
    Encryptor,
    KeyGenerator,
    SchemeType,
    SealContext,
    SecLevelType,
)
from gemini_seal.ciphertext import Ciphertext
from gemini_seal.models.evalmod import (
    ChebyEvalMod,
    _plan_lt,
    fit_cos_cheby,
    plan_evalmod,
)


def _chain(ctx, n_levels):
    cds = [ctx.first_context_data()]
    for _ in range(n_levels):
        nxt = cds[-1].next_context_data
        assert nxt is not None, "test chain too short"
        cds.append(nxt)
    q = [cd.parms.coeff_modulus[-1].value for cd in cds]
    limbs = [cd.limb_constants for cd in cds]
    L = [len(cd.parms.coeff_modulus) for cd in cds]
    return cds, q, limbs, L


def test_fit_cos_cheby_accuracy():
    for K, r in ((3, 2), (12, 3), (68, 4)):
        c = fit_cos_cheby(K, r)
        from numpy.polynomial import chebyshev as C

        y = np.linspace(-1, 1, 4001)
        ref = np.cos((2 * np.pi * (K + 1) * y - np.pi / 2) / 2.0**r)
        got = C.chebval(y, c)
        assert np.abs(got - ref).max() < 1e-8
        # degree tracks the Bessel-decay estimate c_arg + O(c_arg^(1/3))
        c_arg = 2 * np.pi * (K + 1) / 2.0**r
        assert len(c) - 1 < c_arg + 30 * max(c_arg, 1.0) ** (1 / 3) + 40


def test_plan_depth_beats_taylor_chain():
    """At the production shapes the cosine EvalMod must consume fewer
    levels than the round-3 exp trick (4 + r_old), with far smaller
    double-angle noise amplification 2^r."""
    for n in (4096, 16384):
        K = max(12, int(math.ceil(4.5 * math.sqrt(n / 18.0))))
        r_old = int(math.ceil(math.log2(2 * math.pi * (K + 1.5) / 0.15)))
        r, coeffs, depth = plan_evalmod(K)
        assert depth < 4 + r_old
        assert r <= r_old - 6  # >= 64x less noise amplification


@pytest.mark.parametrize("imag", [False, True])
def test_evalmod_engine_e2e(imag):
    """Encrypted sin(2 pi (K+1) y) from slots holding y (or i*y) matches
    numpy to the noise floor of the 45-bit chain."""
    K, r = 3, 2
    rr, coeffs, depth = plan_evalmod(K, r)
    assert rr == r
    n = 64
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(
        CoeffModulus.create(n, [59] + [45] * (depth + 1) + [59]))
    parms.set_random_seed((9, 8, 7, 6, 5, 4, 3, 2))
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    dec = Decryptor(ctx, kg.secret_key)
    encoder = CKKSEncoder(ctx)
    rks = kg.relin_keys().stacked(2)
    Dl = 2.0**45

    cds, q, limbs, L = _chain(ctx, depth + 1)
    em = ChebyEvalMod(ctx, cds, q, limbs, L, encoder, 0, Dl, coeffs, r,
                      imag)
    assert em.depth == depth

    rng = np.random.default_rng(21)
    s = encoder.slot_count
    y = rng.uniform(-1, 1, s)
    vals = (1j * y) if imag else y
    ct = enc.encrypt(encoder.encode(vals.tolist(), Dl))
    out = np.asarray(em.stage(np.asarray(ct.data), rks))

    out_pid = cds[em.depth].parms_id
    got = np.asarray(
        encoder.decode(
            dec.decrypt(Ciphertext(out, out_pid, True, em.sigma_z)),
            as_complex=True,
        )
    )[:s]
    want = np.sin(2 * np.pi * (K + 1) * y)
    assert np.abs(got.real - want).max() < 1e-6
    assert np.abs(got.imag).max() < 1e-6


def test_plan_lt_covers_degree():
    for d in (1, 2, 3, 7, 8, 26, 55, 100, 255):
        l, t = _plan_lt(d)
        assert (1 << (l + t)) > d
        assert l >= 1 and t >= 0
