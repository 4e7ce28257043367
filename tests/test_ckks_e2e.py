"""CKKS end-to-end: encode/encrypt/evaluate/rescale/rotate/decode.

Mirrors the reference's approximate-equality test style
(reference: native/tests/seal/ckks.cpp, evaluator.cpp:1365-3200).
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
    Evaluator,
    KeyGenerator,
    SchemeType,
    SecLevelType,
    SealContext,
)

SEED = tuple(range(21, 29))
SCALE = 2.0 ** 30


@pytest.fixture(scope="module")
def setup():
    parms = EncryptionParameters(SchemeType.CKKS)
    n = 256
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [40, 30, 30, 40]))
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    keygen = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=keygen.public_key(), secret_key=keygen.secret_key)
    dec = Decryptor(ctx, keygen.secret_key)
    ev = Evaluator(ctx)
    encoder = CKKSEncoder(ctx)
    return ctx, keygen, enc, dec, ev, encoder


def close(a, b, tol=1e-4):
    return all(abs(x - y) <= tol for x, y in zip(a, b))


def test_encode_decode(setup):
    *_, encoder = setup
    vals = [1.5, -2.25, 3.125, 0.0, 7.75]
    p = encoder.encode(vals, SCALE)
    out = encoder.decode(p)
    assert close(out[:5], vals, 1e-6)
    assert all(abs(v) < 1e-6 for v in out[5:])


def test_encode_decode_complex(setup):
    *_, encoder = setup
    vals = [complex(1.1, -0.5), complex(-3.25, 2.0)]
    p = encoder.encode(vals, SCALE)
    out = encoder.decode(p, as_complex=True)
    assert abs(out[0] - vals[0]) < 1e-5 and abs(out[1] - vals[1]) < 1e-5


def test_encrypt_decrypt(setup):
    _, _, enc, dec, _, encoder = setup
    vals = [0.1 * i for i in range(encoder.slot_count)]
    ct = enc.encrypt(encoder.encode(vals, SCALE))
    assert ct.is_ntt_form
    out = encoder.decode(dec.decrypt(ct))
    assert close(out, vals, 1e-3)


def test_add_sub(setup):
    _, _, enc, dec, ev, encoder = setup
    a = [1.0, 2.0, -3.0]
    b = [0.5, -1.5, 4.0]
    ca = enc.encrypt(encoder.encode(a, SCALE))
    cb = enc.encrypt(encoder.encode(b, SCALE))
    s = encoder.decode(dec.decrypt(ev.add(ca, cb)))
    assert close(s[:3], [1.5, 0.5, 1.0], 1e-3)
    d = encoder.decode(dec.decrypt(ev.sub(ca, cb)))
    assert close(d[:3], [0.5, 3.5, -7.0], 1e-3)


def test_multiply_relin_rescale(setup):
    _, keygen, enc, dec, ev, encoder = setup
    rk = keygen.relin_keys()
    a = [1.5, -2.0, 0.25]
    b = [2.0, 3.0, -4.0]
    ca = enc.encrypt(encoder.encode(a, SCALE))
    cb = enc.encrypt(encoder.encode(b, SCALE))
    prod = ev.multiply(ca, cb)
    assert prod.size == 3
    rel = ev.relinearize(prod, rk)
    assert rel.size == 2
    scaled = ev.rescale_to_next(rel)
    assert abs(scaled.scale - SCALE * SCALE / scaled_factor(setup)) < 1e6
    out = encoder.decode(dec.decrypt(scaled))
    assert close(out[:3], [3.0, -6.0, -1.0], 1e-2)


def scaled_factor(setup):
    ctx = setup[0]
    return ctx.first_context_data().parms.coeff_modulus[-1].value


def test_multiply_plain_ckks(setup):
    _, _, enc, dec, ev, encoder = setup
    a = [1.0, 2.0, 3.0]
    b = [4.0, 0.5, -2.0]
    ca = enc.encrypt(encoder.encode(a, SCALE))
    pb = encoder.encode(b, SCALE)
    prod = ev.multiply_plain(ca, pb)
    out = encoder.decode(dec.decrypt(ev.rescale_to_next(prod)))
    assert close(out[:3], [4.0, 1.0, -6.0], 1e-2)


def test_add_plain_ckks(setup):
    _, _, enc, dec, ev, encoder = setup
    a = [1.0, -2.0]
    b = [0.25, 0.75]
    ca = enc.encrypt(encoder.encode(a, SCALE))
    pb = encoder.encode(b, SCALE)
    out = encoder.decode(dec.decrypt(ev.add_plain(ca, pb)))
    assert close(out[:2], [1.25, -1.25], 1e-3)


def test_rotate_and_conjugate(setup):
    _, keygen, enc, dec, ev, encoder = setup
    gk = keygen.galois_keys()
    vals = [complex(i + 1, -i) for i in range(4)]
    ct = enc.encrypt(encoder.encode(vals, SCALE))
    rot = ev.rotate_vector(ct, 1, gk)
    out = encoder.decode(dec.decrypt(rot), as_complex=True)
    assert abs(out[0] - vals[1]) < 1e-3
    assert abs(out[1] - vals[2]) < 1e-3
    conj = ev.complex_conjugate(ct, gk)
    outc = encoder.decode(dec.decrypt(conj), as_complex=True)
    assert abs(outc[0] - vals[0].conjugate()) < 1e-3


def test_mod_switch_drop(setup):
    ctx, _, enc, dec, ev, encoder = setup
    vals = [3.5, -1.25]
    ct = enc.encrypt(encoder.encode(vals, SCALE))
    dropped = ev.mod_switch_to_next(ct)
    assert dropped.coeff_modulus_size == ct.coeff_modulus_size - 1
    out = encoder.decode(dec.decrypt(dropped))
    assert close(out[:2], vals, 1e-3)


def test_square_rescale_square(setup):
    _, keygen, enc, dec, ev, encoder = setup
    rk = keygen.relin_keys()
    vals = [1.1, -0.9]
    ct = enc.encrypt(encoder.encode(vals, SCALE))
    sq = ev.rescale_to_next(ev.relinearize(ev.square(ct), rk))
    sq2 = ev.rescale_to_next(ev.relinearize(ev.square(sq), rk))
    out = encoder.decode(dec.decrypt(sq2))
    assert close(out[:2], [1.1 ** 4, 0.9 ** 4], 5e-2)


def test_encode_scalar_double(setup):
    ctx, kg, enc, dec, ev, encoder = setup
    pt = encoder.encode(3.14159, 2.0 ** 30)
    got = encoder.decode(pt, as_complex=True)
    # scalar encodes broadcast to every slot (ckks.cpp:80-173) — check the
    # IMAGINARY parts too: the r3 regression (extra forward NTT on the
    # broadcast residues) kept every real part exact while hiding huge
    # imaginary slot junk (Re[2/(1-zeta)] == 1 identically).
    assert all(abs(g - 3.14159) < 1e-5 for g in got[:8])


def test_scalar_plain_then_square(setup):
    """(x + c)^2 through add_plain(scalar encode) + square — the exact
    failure mode of a mis-formed constant plaintext (imaginary junk makes
    the REAL part of the square wrong: (a+bi)^2 = a^2 - b^2 + ...)."""
    ctx, kg, enc, dec, ev, encoder = setup
    rk = kg.relin_keys()
    scale = 2.0 ** 30
    ct = enc.encrypt(encoder.encode([0.5, -1.25], scale))
    pt = encoder.encode(0.3, scale)
    s = ev.add_plain(ct, pt)
    sq = ev.rescale_to_next(ev.relinearize(ev.square(s), rk))
    got = encoder.decode(dec.decrypt(sq))
    for g, x in zip(got[:2], [0.5, -1.25]):
        assert abs(g - (x + 0.3) ** 2) < 1e-3, (g, (x + 0.3) ** 2)


def test_encode_int64(setup):
    ctx, kg, enc, dec, ev, encoder = setup
    pt = encoder.encode_int(-7)
    got = encoder.decode(pt)
    assert all(abs(g + 7) < 1e-6 for g in got[:8])


def test_encode_complex_roundtrip(setup):
    ctx, kg, enc, dec, ev, encoder = setup
    vals = [1 + 2j, -0.5 - 0.25j, 3.0 + 0j]
    pt = encoder.encode(vals, 2.0 ** 30)
    got = encoder.decode(pt, as_complex=True)
    for g, w in zip(got[:3], vals):
        assert abs(g - w) < 1e-5


def test_conjugate_on_complex(setup):
    ctx, kg, enc, dec, ev, encoder = setup
    gk = kg.galois_keys()
    vals = [1 + 2j, -0.5 - 0.25j]
    ct = enc.encrypt(encoder.encode(vals, 2.0 ** 30))
    conj = ev.complex_conjugate(ct, gk)
    got = encoder.decode(dec.decrypt(conj), as_complex=True)
    for g, w in zip(got[:2], vals):
        assert abs(g - w.conjugate()) < 1e-4


def test_missing_power_of_two_key_raises(setup):
    """A power-of-two rotation step whose key is absent must raise cleanly
    (reference: evaluator.cpp:1977-1989 NAF-size-1 throw), not recurse
    forever. Regression for the round-2 RecursionError."""
    ctx, kg, enc, dec, ev, encoder = setup
    # keys ONLY for step 1: NAF(4) == [4] — single term, key absent.
    gk = kg.galois_keys_from_steps([1])
    ct = enc.encrypt(encoder.encode([1.0, 2.0], SCALE))
    with pytest.raises(ValueError, match="Galois key not present"):
        ev.rotate_vector(ct, 4, gk)
    # composite steps whose NAF terms all have keys still work:
    # NAF(3) == [4, -1], both keys present.
    gk3 = kg.galois_keys_from_steps([4, -1])
    vals = [float(i) for i in range(encoder.slot_count)]
    ct3 = enc.encrypt(encoder.encode(vals, SCALE))
    out = encoder.decode(dec.decrypt(ev.rotate_vector(ct3, 3, gk3)))
    assert close(out[:4], [3.0, 4.0, 5.0, 6.0], 1e-2)


def test_rotate_checks_galois_parms_id(setup):
    """rotate_internal validates key parms before any work
    (reference: evaluator.cpp:1957-1960)."""
    ctx, kg, enc, dec, ev, encoder = setup
    gk = kg.galois_keys_from_steps([1])
    gk.parms_id = (0, 0, 0, 0)
    ct = enc.encrypt(encoder.encode([1.0], SCALE))
    with pytest.raises(ValueError, match="galois_keys is not valid"):
        ev.rotate_vector(ct, 1, gk)
