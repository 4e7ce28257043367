"""End-to-end BFV: keygen -> encrypt -> (add) -> decrypt.

Mirrors the reference's round-trip test style
(reference: native/tests/seal/encryptor.cpp, evaluator.cpp:1066+): tiny
insecure parameters, exact plaintext comparison.
"""

import numpy as np
import pytest

from gemini_seal import (
    CoeffModulus,
    Decryptor,
    EncryptionParameters,
    Encryptor,
    KeyGenerator,
    Plaintext,
    SchemeType,
    SecLevelType,
    SealContext,
)

SEED = tuple(range(1, 9))


def make_ctx(n=64, bits=(40,), t=257, seed=SEED):
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, list(bits)))
    parms.set_plain_modulus(t)
    if seed is not None:
        parms.set_random_seed(seed)
    return SealContext(parms, sec_level=SecLevelType.none)


@pytest.fixture(scope="module")
def ctx():
    return make_ctx()


@pytest.fixture(scope="module")
def actors(ctx):
    keygen = KeyGenerator(ctx)
    pk = keygen.public_key()
    encryptor = Encryptor(ctx, public_key=pk, secret_key=keygen.secret_key)
    decryptor = Decryptor(ctx, keygen.secret_key)
    return keygen, encryptor, decryptor


def test_encrypt_decrypt_roundtrip(ctx, actors):
    _, encryptor, decryptor = actors
    plain = Plaintext.from_hex("1x^2 + 2x + 3")
    ct = encryptor.encrypt(plain)
    assert ct.size == 2 and not ct.is_ntt_form
    out = decryptor.decrypt(ct)
    assert out.to_hex() == "1x^2 + 2x + 3"


def test_encrypt_zero(ctx, actors):
    _, encryptor, decryptor = actors
    ct = encryptor.encrypt(Plaintext.from_hex("0"))
    out = decryptor.decrypt(ct)
    assert out.to_hex() == "0"


def test_symmetric_encrypt_decrypt(ctx, actors):
    _, encryptor, decryptor = actors
    plain = Plaintext.from_hex("7Fx^3 + 1")
    ct = encryptor.encrypt_symmetric(plain)
    out = decryptor.decrypt(ct)
    assert out.to_hex().lower() == "7fx^3 + 1"


def test_noise_budget_positive(ctx, actors):
    _, encryptor, decryptor = actors
    ct = encryptor.encrypt(Plaintext.from_hex("5"))
    budget = decryptor.invariant_noise_budget(ct)
    assert budget > 0


def test_full_coeff_plaintext(ctx, actors):
    _, encryptor, decryptor = actors
    rng = np.random.default_rng(3)
    coeffs = rng.integers(0, 257, size=64, dtype=np.uint64)
    coeffs[-1] = max(coeffs[-1], 1)  # keep degree maximal
    plain = Plaintext(data=coeffs)
    ct = encryptor.encrypt(plain)
    out = decryptor.decrypt(ct)
    got = np.zeros(64, dtype=np.uint64)
    got[: out.data.shape[0]] = out.data
    assert np.array_equal(got, coeffs)


def test_multi_limb_params(actors):
    ctx = make_ctx(n=128, bits=(40, 40, 40), t=65537)
    keygen = KeyGenerator(ctx)
    encryptor = Encryptor(ctx, public_key=keygen.public_key())
    decryptor = Decryptor(ctx, keygen.secret_key)
    plain = Plaintext.from_hex("1234x^5 + ABx^2 + 3")
    ct = encryptor.encrypt(plain)
    # L at first level = 2 (one modulus dropped below key level)
    assert ct.coeff_modulus_size == 2
    out = decryptor.decrypt(ct)
    assert out.to_hex().lower() == "1234x^5 + abx^2 + 3"


def test_seeded_determinism(ctx):
    keygen1 = KeyGenerator(ctx)
    keygen2 = KeyGenerator(ctx)
    assert np.array_equal(
        np.asarray(keygen1.secret_key.data), np.asarray(keygen2.secret_key.data)
    )


def test_encrypt_zero_at_lower_level(actors):
    """Zero-encryption below the first level mod-switches down from the
    previous level (reference: encryptor.cpp:144-173)."""
    from gemini_seal import CoeffModulus, EncryptionParameters, SchemeType, SecLevelType, SealContext

    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(64)
    parms.set_coeff_modulus(CoeffModulus.create(64, [40, 40, 40]))
    parms.set_plain_modulus(257)
    parms.set_random_seed(tuple(range(8)))
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key(), secret_key=kg.secret_key)
    dec = Decryptor(ctx, kg.secret_key)

    lower = ctx.first_context_data().next_context_data.parms_id
    for asym in (True, False):
        ct = enc.encrypt_zero(lower, is_asymmetric=asym)
        assert ct.parms_id == lower
        out = dec.decrypt(ct)
        assert out.significant_coeff_count() <= 1
        import numpy as np
        assert not np.asarray(out.data).any()
