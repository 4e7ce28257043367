"""Dedicated square paths are bit-identical to multiply(x, x) on every
plane (host Evaluator, DeviceEvaluator, jitted pipelines) — the reference's
square is the same convolution with 2*c0*c1 = c0*c1 + c1*c0
(reference: evaluator.cpp:560-770 bfv_square/ckks_square)."""

import numpy as np
import pytest

from gemini_seal import (
    CKKSEncoder,
    CoeffModulus,
    Decryptor,
    EncryptionParameters,
    Encryptor,
    Evaluator,
    KeyGenerator,
    Plaintext,
    SchemeType,
    SecLevelType,
    SealContext,
)
from gemini_seal.models.device_evaluator import DeviceEvaluator

SEED = tuple(range(41, 49))


@pytest.fixture(scope="module")
def bfv():
    parms = EncryptionParameters(SchemeType.BFV)
    n = 64
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [40, 40, 40]))
    parms.set_plain_modulus(257)
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key(), secret_key=kg.secret_key)
    dec = Decryptor(ctx, kg.secret_key)
    return ctx, kg, enc, dec


@pytest.fixture(scope="module")
def ckks():
    parms = EncryptionParameters(SchemeType.CKKS)
    n = 256
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [40, 30, 40]))
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    return ctx, kg, enc, CKKSEncoder(ctx)


def test_bfv_square_bit_exact_vs_multiply(bfv):
    ctx, kg, enc, dec = bfv
    ev = Evaluator(ctx)
    ct = enc.encrypt(Plaintext.from_hex("3x^5 + 2x^2 + 1"))
    sq = ev.square(ct)
    mu = ev.multiply(ct, ct)
    np.testing.assert_array_equal(np.asarray(sq.data), np.asarray(mu.data))
    assert sq.size == 3
    assert dec.decrypt(sq).to_hex() == dec.decrypt(mu).to_hex()


def test_bfv_square_size3_fallback(bfv):
    ctx, kg, enc, dec = bfv
    ev = Evaluator(ctx)
    ct = enc.encrypt(Plaintext.from_hex("2x^1 + 1"))
    ct3 = ev.multiply(ct, ct)          # size 3
    sq = ev.square(ct3)                # falls back to multiply(x, x)
    mu = ev.multiply(ct3, ct3)
    np.testing.assert_array_equal(np.asarray(sq.data), np.asarray(mu.data))
    assert sq.size == 5


def test_ckks_square_bit_exact_vs_multiply(ckks):
    ctx, kg, enc, encoder = ckks
    ev = Evaluator(ctx)
    scale = 2.0 ** 30
    ct = enc.encrypt(encoder.encode([0.5, -1.25, 2.0], scale))
    sq = ev.square(ct)
    mu = ev.multiply(ct, ct)
    np.testing.assert_array_equal(np.asarray(sq.data), np.asarray(mu.data))
    assert sq.scale == mu.scale
    assert sq.is_ntt_form


def test_device_square_matches_host(bfv, ckks):
    bctx, bkg, benc, _ = bfv
    cctx, ckg, cenc, encoder = ckks

    ev = Evaluator(bctx)
    dev = DeviceEvaluator(bctx)
    ct = benc.encrypt(Plaintext.from_hex("5x^3 + 4"))
    host = ev.square(ct)
    got = dev.get(dev.square(dev.put(ct)))
    np.testing.assert_array_equal(np.asarray(got.data), np.asarray(host.data))

    ev = Evaluator(cctx)
    dev = DeviceEvaluator(cctx)
    ct = cenc.encrypt(encoder.encode([1.5, 0.25], 2.0 ** 30))
    host = ev.square(ct)
    got = dev.get(dev.square(dev.put(ct)))
    np.testing.assert_array_equal(np.asarray(got.data), np.asarray(host.data))
    assert got.scale == host.scale


def test_pipeline_ckks_square_bit_exact(ckks):
    import jax

    ctx, kg, enc, encoder = ckks
    from gemini_seal.models.pipelines import build_ckks_mul_relin_rescale

    rk = kg.relin_keys()
    rk_data = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
    ct = enc.encrypt(encoder.encode([0.5, -1.0, 2.0], 2.0 ** 30))
    a = np.asarray(ct.data)

    mul = jax.jit(build_ckks_mul_relin_rescale(ctx))
    sq = jax.jit(build_ckks_mul_relin_rescale(ctx, square=True))
    np.testing.assert_array_equal(np.asarray(sq(a, rk_data)),
                                  np.asarray(mul(a, a, rk_data)))

    # fused variant: square == multiply(a, a) under the same fused mod-down
    mul_f = jax.jit(build_ckks_mul_relin_rescale(ctx, fused=True))
    sq_f = jax.jit(build_ckks_mul_relin_rescale(ctx, fused=True, square=True))
    np.testing.assert_array_equal(np.asarray(sq_f(a, rk_data)),
                                  np.asarray(mul_f(a, a, rk_data)))


def test_pipeline_bfv_square_bit_exact(bfv):
    import jax

    ctx, kg, enc, dec = bfv
    from gemini_seal.models.pipelines import build_bfv_mul_relin

    rk = kg.relin_keys()
    rk_data = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
    ct = enc.encrypt(Plaintext.from_hex("6x^4 + 5"))
    a = np.asarray(ct.data)

    mul = jax.jit(build_bfv_mul_relin(ctx))
    sq = jax.jit(build_bfv_mul_relin(ctx, square=True))
    np.testing.assert_array_equal(np.asarray(sq(a, rk_data)),
                                  np.asarray(mul(a, a, rk_data)))
