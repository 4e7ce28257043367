"""BFV Evaluator tests: add/sub/negate/plain ops/multiply/relinearize/
mod-switch/galois — round-trip style mirroring the reference's
tests/seal/evaluator.cpp (tiny insecure parameters, exact comparison)."""

import numpy as np
import pytest

from gemini_seal import (
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

SEED = tuple(range(11, 19))
T = 257


def poly_mul_mod_t(a, b, n, t):
    """schoolbook negacyclic product mod (x^n + 1, t)"""
    out = [0] * n
    for i, ai in enumerate(a):
        if not ai:
            continue
        for j, bj in enumerate(b):
            k = i + j
            v = ai * bj
            if k >= n:
                out[k - n] = (out[k - n] - v) % t
            else:
                out[k] = (out[k] + v) % t
    return out


def plain_coeffs(p: Plaintext, n: int):
    out = np.zeros(n, dtype=np.int64)
    d = np.asarray(p.data)
    out[: d.shape[0]] = d
    return [int(v) for v in out]


@pytest.fixture(scope="module")
def setup():
    parms = EncryptionParameters(SchemeType.BFV)
    n = 64
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [40, 40, 40]))
    parms.set_plain_modulus(T)
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    keygen = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=keygen.public_key(), secret_key=keygen.secret_key)
    dec = Decryptor(ctx, keygen.secret_key)
    ev = Evaluator(ctx)
    return ctx, keygen, enc, dec, ev


def test_negate(setup):
    _, _, enc, dec, ev = setup
    ct = enc.encrypt(Plaintext.from_hex("5x^2 + 1"))
    out = dec.decrypt(ev.negate(ct))
    assert plain_coeffs(out, 64)[:3] == [T - 1, 0, T - 5]


def test_add_sub(setup):
    _, _, enc, dec, ev = setup
    a = enc.encrypt(Plaintext.from_hex("3x^1 + 2"))
    b = enc.encrypt(Plaintext.from_hex("5x^2 + 4"))
    s = dec.decrypt(ev.add(a, b))
    assert plain_coeffs(s, 64)[:3] == [6, 3, 5]
    d = dec.decrypt(ev.sub(a, b))
    assert plain_coeffs(d, 64)[:3] == [(2 - 4) % T, 3, (0 - 5) % T]


def test_add_plain_sub_plain(setup):
    _, _, enc, dec, ev = setup
    ct = enc.encrypt(Plaintext.from_hex("2x^2 + 1"))
    out = dec.decrypt(ev.add_plain(ct, Plaintext.from_hex("Fx^1 + 3")))
    assert plain_coeffs(out, 64)[:3] == [4, 15, 2]
    out2 = dec.decrypt(ev.sub_plain(ct, Plaintext.from_hex("1x^2 + 5")))
    assert plain_coeffs(out2, 64)[:3] == [(1 - 5) % T, 0, 1]


def test_multiply_plain(setup):
    _, _, enc, dec, ev = setup
    a = [3, 0, 1, 7]
    b = [2, 5, 0, 0, 11]
    ct = enc.encrypt(Plaintext(data=np.array(a, dtype=np.uint64)))
    prod = ev.multiply_plain(ct, Plaintext(data=np.array(b, dtype=np.uint64)))
    out = dec.decrypt(prod)
    assert plain_coeffs(out, 64) == poly_mul_mod_t(a, b, 64, T)


def test_multiply_plain_monomial(setup):
    _, _, enc, dec, ev = setup
    ct = enc.encrypt(Plaintext.from_hex("3x^2 + 1"))
    prod = ev.multiply_plain(ct, Plaintext.from_hex("2x^5"))
    out = dec.decrypt(prod)
    assert plain_coeffs(out, 64) == poly_mul_mod_t([1, 0, 3], [0] * 5 + [2], 64, T)


def test_multiply_and_budget(setup):
    _, _, enc, dec, ev = setup
    a = [1, 2, 3]
    b = [4, 0, 5]
    ca = enc.encrypt(Plaintext(data=np.array(a, dtype=np.uint64)))
    cb = enc.encrypt(Plaintext(data=np.array(b, dtype=np.uint64)))
    prod = ev.multiply(ca, cb)
    assert prod.size == 3
    out = dec.decrypt(prod)
    assert plain_coeffs(out, 64) == poly_mul_mod_t(a, b, 64, T)
    assert dec.invariant_noise_budget(prod) > 0


def test_relinearize(setup):
    _, keygen, enc, dec, ev = setup
    rk = keygen.relin_keys()
    a = [1, 2, 3]
    b = [4, 0, 5]
    ca = enc.encrypt(Plaintext(data=np.array(a, dtype=np.uint64)))
    cb = enc.encrypt(Plaintext(data=np.array(b, dtype=np.uint64)))
    prod = ev.multiply(ca, cb)
    rel = ev.relinearize(prod, rk)
    assert rel.size == 2
    budget = dec.invariant_noise_budget(rel)
    assert budget > 0, "relinearize destroyed the ciphertext"
    out = dec.decrypt(rel)
    assert plain_coeffs(out, 64) == poly_mul_mod_t(a, b, 64, T)


def test_square_then_relin_then_square(setup):
    _, keygen, enc, dec, ev = setup
    rk = keygen.relin_keys()
    a = [0, 1]  # x
    ct = enc.encrypt(Plaintext(data=np.array(a, dtype=np.uint64)))
    sq = ev.relinearize(ev.square(ct), rk)
    sq2 = ev.relinearize(ev.square(sq), rk)
    out = dec.decrypt(sq2)
    assert plain_coeffs(out, 64) == poly_mul_mod_t([0, 0, 0, 0, 1], [1], 64, T)


def test_mod_switch_to_next(setup):
    ctx, _, enc, dec, ev = setup
    ct = enc.encrypt(Plaintext.from_hex("7x^3 + 2"))
    switched = ev.mod_switch_to_next(ct)
    assert switched.coeff_modulus_size == ct.coeff_modulus_size - 1
    out = dec.decrypt(switched)
    assert plain_coeffs(out, 64)[:4] == [2, 0, 0, 7]


def test_apply_galois(setup):
    _, keygen, enc, dec, ev = setup
    gk = keygen.galois_keys([3])
    # m(x) = 1 + 2x -> m(x^3) = 1 + 2x^3
    ct = enc.encrypt(Plaintext.from_hex("2x^1 + 1"))
    rot = ev.apply_galois(ct, 3, gk)
    out = dec.decrypt(rot)
    assert plain_coeffs(out, 64)[:4] == [1, 0, 0, 2]
    assert dec.invariant_noise_budget(rot) > 0


def test_apply_galois_negative_wrap(setup):
    _, keygen, enc, dec, ev = setup
    n = 64
    gk = keygen.galois_keys([3])
    # x^63 -> x^189 = x^(189-2*64)*(-1)^... : 189 = 64+125? compute directly
    ct = enc.encrypt(Plaintext(data=np.array([0] * 63 + [1], dtype=np.uint64)))
    rot = ev.apply_galois(ct, 3, gk)
    out = dec.decrypt(rot)
    # x^(63*3) = x^189; 189 mod 128 = 61, and floor(189/64)=2 wraps: sign +
    # 189 = 2*64 + 61 -> (-1)^2 x^61 = x^61
    expect = [0] * 64
    expect[61] = 1
    assert plain_coeffs(out, 64) == expect


def test_multiply_many_exponentiate(setup):
    _, keygen, enc, dec, ev = setup
    rk = keygen.relin_keys()
    cts = [
        enc.encrypt(Plaintext.from_hex(h)) for h in ("2", "3", "4")
    ]
    prod = ev.multiply_many(cts, rk)
    out = dec.decrypt(prod)
    assert plain_coeffs(out, 64)[0] == 24
    ct = enc.encrypt(Plaintext.from_hex("2"))
    p4 = ev.exponentiate(ct, 4, rk)
    assert plain_coeffs(dec.decrypt(p4), 64)[0] == 16


# ---------------------------------------------------------------------------
# Multiple coeff-modulus regimes (reference runs each test under several
# modulus sets, e.g. {40}, {40,40}, {59,59,59}) and the remaining op surface.
# ---------------------------------------------------------------------------

def make_regime(bits, t=257, n=64):
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, list(bits)))
    parms.set_plain_modulus(t)
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    dec = Decryptor(ctx, kg.secret_key)
    return ctx, kg, enc, dec, Evaluator(ctx)


@pytest.mark.parametrize("bits", [[40, 40], [59, 59, 59], [30, 30, 30, 30]])
def test_multiply_regimes(bits):
    ctx, kg, enc, dec, ev = make_regime(bits)
    a = Plaintext.from_hex("3x^3 + 2x^1 + 1")
    b = Plaintext.from_hex("5x^2 + 4")
    ct = ev.multiply(enc.encrypt(a), enc.encrypt(b))
    got = plain_coeffs(dec.decrypt(ct), 64)
    want = poly_mul_mod_t(plain_coeffs(a, 64), plain_coeffs(b, 64), 64, T)
    assert got == want


def test_transform_to_from_ntt_roundtrip():
    ctx, kg, enc, dec, ev = make_regime([40, 40])
    pt = Plaintext.from_hex("7x^5 + 3x^2 + 2")
    ct = enc.encrypt(pt)
    ntt = ev.transform_to_ntt(ct)
    assert ntt.is_ntt_form
    back = ev.transform_from_ntt(ntt)
    assert not back.is_ntt_form
    np.testing.assert_array_equal(np.asarray(back.data), np.asarray(ct.data))
    assert plain_coeffs(dec.decrypt(back), 64) == plain_coeffs(pt, 64)


def test_multiply_plain_in_ntt_domain():
    ctx, kg, enc, dec, ev = make_regime([40, 40])
    pt = Plaintext.from_hex("2x^2 + 3")
    mult = Plaintext.from_hex("4x^1 + 1")
    ct = ev.transform_to_ntt(enc.encrypt(pt))
    pm = ev.transform_plain_to_ntt(mult, ct.parms_id)
    prod = ev.transform_from_ntt(ev.multiply_plain(ct, pm))
    got = plain_coeffs(dec.decrypt(prod), 64)
    want = poly_mul_mod_t(plain_coeffs(pt, 64), plain_coeffs(mult, 64), 64, T)
    assert got == want


def test_mod_switch_plain_to_next():
    ctx, kg, enc, dec, ev = make_regime([40, 40, 40])
    pt = Plaintext.from_hex("6x^4 + 5")
    ct = enc.encrypt(pt)
    ct2 = ev.mod_switch_to_next(ct)
    ct3 = ev.mod_switch_to(ct, ctx.last_parms_id)
    assert plain_coeffs(dec.decrypt(ct2), 64) == plain_coeffs(pt, 64)
    assert plain_coeffs(dec.decrypt(ct3), 64) == plain_coeffs(pt, 64)


def test_exponentiate_regime():
    ctx, kg, enc, dec, ev = make_regime([59, 59, 59])
    pt = Plaintext.from_hex("2")
    rk = kg.relin_keys()
    ct = ev.exponentiate(enc.encrypt(pt), 4, rk)
    got = plain_coeffs(dec.decrypt(ct), 64)
    assert got[0] == 16 and not any(got[1:])


def test_sub_different_sizes():
    ctx, kg, enc, dec, ev = make_regime([59, 59, 59])
    a = enc.encrypt(Plaintext.from_hex("5x^1 + 3"))
    b = enc.encrypt(Plaintext.from_hex("2x^1 + 1"))
    big = ev.multiply(a, a)          # size 3
    out = ev.sub(big, b)
    want = poly_mul_mod_t(plain_coeffs(Plaintext.from_hex("5x^1 + 3"), 64),
                          plain_coeffs(Plaintext.from_hex("5x^1 + 3"), 64), 64, T)
    want[0] = (want[0] - 1) % T
    want[1] = (want[1] - 2) % T
    assert plain_coeffs(dec.decrypt(out), 64) == want
    out2 = ev.sub(b, big)            # smaller minus larger
    neg = [(T - v) % T for v in want]
    assert plain_coeffs(dec.decrypt(out2), 64) == neg


def test_mod_switch_to_fused_matches_sequential_decrypt():
    ctx, kg, enc, dec, ev = make_regime([50, 40, 40, 40], t=257)
    pt = Plaintext.from_hex("6x^5 + 3x^2 + 2")
    ct = enc.encrypt(pt)
    seq = ev.mod_switch_to(ct, ctx.last_parms_id)
    fus = ev.mod_switch_to(ct, ctx.last_parms_id, fused=True)
    assert fus.parms_id == seq.parms_id
    assert plain_coeffs(dec.decrypt(fus), 64) == plain_coeffs(dec.decrypt(seq), 64)
