"""Ciphertext health metrics (SURVEY §5 observability; noise budget
reference: decryptor.cpp:269-325)."""

from gemini_seal import (
    CKKSEncoder,
    CoeffModulus,
    Decryptor,
    EncryptionParameters,
    Encryptor,
    Evaluator,
    KeyGenerator,
    PlainModulus,
    Plaintext,
    SchemeType,
    SecLevelType,
    SealContext,
)
from gemini_seal.metrics import inspect

SEED = tuple(range(41, 49))


def test_bfv_metrics_track_noise():
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(64)
    parms.set_coeff_modulus(CoeffModulus.create(64, [40, 40, 40]))
    parms.set_plain_modulus(PlainModulus.batching(64, 20))
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    dec = Decryptor(ctx, kg.secret_key)
    ev = Evaluator(ctx)

    ct = enc.encrypt(Plaintext.from_hex("3x^2 + 2"))
    m0 = inspect(ct, ctx, dec)
    assert m0.scheme == "BFV" and m0.size == 2 and not m0.is_ntt_form
    assert m0.noise_budget_bits > 0 and m0.headroom_ok()

    sq = ev.multiply(ct, ct)
    m1 = inspect(sq, ctx, dec)
    assert m1.size == 3
    assert m1.noise_budget_bits < m0.noise_budget_bits  # noise grew


def test_ckks_metrics_track_scale_and_level():
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(64)
    parms.set_coeff_modulus(CoeffModulus.create(64, [40, 30, 40]))
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    ev = Evaluator(ctx)
    encoder = CKKSEncoder(ctx)
    rk = kg.relin_keys()

    ct = enc.encrypt(encoder.encode([1.0], 2.0 ** 30))
    m0 = inspect(ct, ctx)
    assert m0.scheme == "CKKS" and m0.is_ntt_form
    assert abs(m0.log2_scale - 30) < 1e-9

    down = ev.rescale_to_next(ev.relinearize(ev.multiply(ct, ct), rk))
    m1 = inspect(down, ctx)
    assert m1.level == m0.level - 1
    assert m1.coeff_modulus_bits < m0.coeff_modulus_bits
    assert m1.headroom_ok(min_budget_bits=5)
    assert not m1.headroom_ok(min_budget_bits=30)
