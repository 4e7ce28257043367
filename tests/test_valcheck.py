"""Validity-check tests (reference: native/tests/seal/... valcheck usage;
valcheck.h:32-197 semantics)."""

import numpy as np

from gemini_seal import (
    Ciphertext,
    CoeffModulus,
    EncryptionParameters,
    Encryptor,
    KeyGenerator,
    PlainModulus,
    Plaintext,
    SchemeType,
    SecLevelType,
    SealContext,
)
from gemini_seal.valcheck import (
    is_buffer_valid,
    is_data_valid_for,
    is_metadata_valid_for,
    is_valid_for,
)


def make():
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(64)
    parms.set_coeff_modulus(CoeffModulus.create(64, [40, 40]))
    parms.set_plain_modulus(PlainModulus.batching(64, 20))
    parms.set_random_seed(tuple(range(8)))
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    return ctx, KeyGenerator(ctx)


def test_valid_objects_pass():
    ctx, kg = make()
    enc = Encryptor(ctx, public_key=kg.public_key())
    pt = Plaintext.from_hex("3x^2 + 2")
    ct = enc.encrypt(pt)
    assert is_valid_for(pt, ctx)
    assert is_valid_for(ct, ctx)
    assert is_valid_for(kg.secret_key, ctx)
    assert is_valid_for(kg.public_key(), ctx)
    assert is_valid_for(kg.relin_keys(), ctx)
    assert is_valid_for(kg.galois_keys(), ctx)


def test_wrong_context_rejected():
    ctx, kg = make()
    enc = Encryptor(ctx, public_key=kg.public_key())
    ct = enc.encrypt(Plaintext.from_hex("1"))

    parms2 = EncryptionParameters(SchemeType.BFV)
    parms2.set_poly_modulus_degree(128)
    parms2.set_coeff_modulus(CoeffModulus.create(128, [40, 40]))
    parms2.set_plain_modulus(257)
    ctx2 = SealContext(parms2, sec_level=SecLevelType.none)
    assert not is_metadata_valid_for(ct, ctx2)
    assert not is_valid_for(ct, ctx2)


def test_out_of_bound_data_rejected():
    ctx, kg = make()
    enc = Encryptor(ctx, public_key=kg.public_key())
    ct = enc.encrypt(Plaintext.from_hex("1"))
    bad = np.array(ct.data, copy=True)
    bad[0, 0, 0] = np.uint64(0xFFFFFFFFFFFFFFFF)  # >= q_0
    bad_ct = Ciphertext(bad, ct.parms_id, ct.is_ntt_form, ct.scale)
    assert is_metadata_valid_for(bad_ct, ctx)
    assert not is_data_valid_for(bad_ct, ctx)
    assert not is_valid_for(bad_ct, ctx)


def test_plain_too_long_rejected():
    ctx, _ = make()
    too_long = Plaintext(data=np.ones(65, dtype=np.uint64))
    assert not is_metadata_valid_for(too_long, ctx)


def test_ingest_rejects_malformed_objects():
    """Serialization is the trust boundary: loaders run
    the full metadata + per-limb residue validation, mirroring the
    reference's checked load (valcheck.cpp is_data_valid_for after
    unsafe_load)."""
    import pytest
    from gemini_seal import serialization as ser

    ctx, kg = make()
    enc = Encryptor(ctx, public_key=kg.public_key())
    ct = enc.encrypt(Plaintext.from_hex("5x^3 + 4"))

    # honest blob loads
    blob = ser.save(ct)
    ser.load_ciphertext(blob, ctx)

    # corrupt one residue to >= q_0: the IntArray payload starts after the
    # outer header (16) + parms_id (32) + ntt flag (1) + 3x u64 + double
    # (32) + inner header (16) + count (8)
    off = 16 + 32 + 1 + 24 + 8 + 16 + 8
    bad = bytearray(blob)
    bad[off : off + 8] = b"\xff" * 8
    with pytest.raises(ValueError, match="residues out of bounds"):
        ser.load_ciphertext(bytes(bad), ctx)
    # unchecked escape hatch still loads (reference unsafe_load parity)
    ser.load_ciphertext(bytes(bad), ctx, validate=False)

    # corrupted key-switch keys are rejected at ingest
    rk = kg.relin_keys()
    rk_blob = bytearray(ser.save(rk))
    # flip a byte deep inside the first key ciphertext's data
    rk_off = 16 + 32 + 8 + 8 + 16 + 32 + 1 + 24 + 8 + 16 + 8
    rk_blob[rk_off : rk_off + 8] = b"\xff" * 8
    with pytest.raises(ValueError, match="residues out of bounds"):
        ser.load_relin_keys(bytes(rk_blob), ctx)

    # secret key residue bounds
    sk_blob = bytearray(ser.save(kg.secret_key))
    sk_off = 16 + 32 + 8 + 8 + 16 + 8
    sk_blob[sk_off : sk_off + 8] = b"\xff" * 8
    with pytest.raises(ValueError, match="residues out of bounds"):
        ser.load_secret_key(bytes(sk_blob), ctx)


def test_key_level_ciphertext_rejected_at_ingest():
    """An ordinary ciphertext claiming the key level is metadata-invalid
    (valcheck.cpp:70-84) and must be rejected on load."""
    import pytest
    from gemini_seal import serialization as ser

    ctx, kg = make()
    key_cd = ctx.key_context_data()
    L = len(key_cd.parms.coeff_modulus)
    n = key_cd.parms.poly_modulus_degree
    forged = Ciphertext(
        np.zeros((2, L, n), dtype=np.uint64), key_cd.parms_id, False, 1.0
    )
    forged_blob = ser.save(forged)
    with pytest.raises(ValueError, match="metadata is invalid"):
        ser.load_ciphertext(forged_blob, ctx)
