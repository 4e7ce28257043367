"""BatchEncoder SIMD tests (reference: tests/seal/batchencoder.cpp) and
BFV rotations over batched slots (reference: tests/seal/evaluator.cpp
rotate tests — the reference's own BFV rotations are broken by the fork's
key-switch rewrite; these verify the corrected behavior)."""

import numpy as np
import pytest

from gemini_seal import (
    BatchEncoder,
    CoeffModulus,
    Decryptor,
    EncryptionParameters,
    Encryptor,
    Evaluator,
    IntegerEncoder,
    KeyGenerator,
    PlainModulus,
    SchemeType,
    SecLevelType,
    SealContext,
)

SEED = tuple(range(31, 39))


@pytest.fixture(scope="module")
def setup():
    parms = EncryptionParameters(SchemeType.BFV)
    n = 64
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [40, 40, 40]))
    parms.set_plain_modulus(PlainModulus.batching(n, 20))
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    keygen = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=keygen.public_key())
    dec = Decryptor(ctx, keygen.secret_key)
    ev = Evaluator(ctx)
    be = BatchEncoder(ctx)
    return ctx, keygen, enc, dec, ev, be


def test_encode_decode_roundtrip(setup):
    *_, be = setup
    vals = list(range(be.slot_count))
    p = be.encode(vals)
    assert be.decode(p) == vals


def test_signed_roundtrip(setup):
    *_, be = setup
    vals = [5, -3, 0, -1, 2] + [0] * (be.slot_count - 5)
    p = be.encode(vals)
    assert be.decode(p, signed=True) == vals


def test_slotwise_ops(setup):
    _, _, enc, dec, ev, be = setup
    n = be.slot_count
    a = [i % 7 for i in range(n)]
    b = [(3 * i) % 5 for i in range(n)]
    ca = enc.encrypt(be.encode(a))
    cb = enc.encrypt(be.encode(b))
    t = 0
    ctx = setup[0]
    t = ctx.first_context_data().parms.plain_modulus.value
    s = be.decode(dec.decrypt(ev.add(ca, cb)))
    assert s == [(x + y) % t for x, y in zip(a, b)]
    m = be.decode(dec.decrypt(ev.multiply(ca, cb)))
    assert m == [(x * y) % t for x, y in zip(a, b)]


def test_rotate_rows(setup):
    _, keygen, enc, dec, ev, be = setup
    gk = keygen.galois_keys()
    n = be.slot_count
    row = n // 2
    vals = list(range(n))
    ct = enc.encrypt(be.encode(vals))
    rot = ev.rotate_rows(ct, 1, gk)
    out = be.decode(dec.decrypt(rot))
    expect = vals[1:row] + vals[:1] + vals[row + 1 :] + vals[row : row + 1]
    assert out == expect
    # negative rotation
    rot2 = ev.rotate_rows(ct, -2, gk)
    out2 = be.decode(dec.decrypt(rot2))
    expect2 = vals[row - 2 : row] + vals[: row - 2] + vals[-2:] + vals[row : -2]
    assert out2 == expect2


def test_rotate_columns(setup):
    _, keygen, enc, dec, ev, be = setup
    gk = keygen.galois_keys()
    n = be.slot_count
    row = n // 2
    vals = list(range(n))
    ct = enc.encrypt(be.encode(vals))
    swapped = ev.rotate_columns(ct, gk)
    out = be.decode(dec.decrypt(swapped))
    assert out == vals[row:] + vals[:row]


def test_integer_encoder(setup):
    ctx, _, enc, dec, ev, _ = setup
    ie = IntegerEncoder(ctx)
    for v in (0, 1, -1, 64, -100, 12345):
        p = ie.encode(v)
        assert ie.decode(p) == v
    # homomorphic add via integer encoding
    ca = enc.encrypt(ie.encode(7))
    cb = enc.encrypt(ie.encode(-3))
    out = ie.decode(dec.decrypt(ev.add(ca, cb)))
    assert out == 4


# ---------------------------------------------------------------------------
# generator-3 compat mode (reference slot-order interop)
# ---------------------------------------------------------------------------

def test_compat_gen3_roundtrip_and_distinct_map(setup):
    ctx, keygen, enc, dec, ev, be = setup
    bc = BatchEncoder(ctx, compat_gen3=True)
    n = bc.slot_count
    vals = [(5 * i + 1) % 17 for i in range(n)]
    assert bc.decode(dec.decrypt(enc.encrypt(bc.encode(vals)))) == vals
    # the two maps genuinely differ (same plaintext -> different slot order)
    assert not np.array_equal(bc._index_map, be._index_map)
    cross = be.decode(dec.decrypt(enc.encrypt(bc.encode(vals))))
    assert cross != vals


def test_compat_gen3_row_rotation(setup):
    """On gen-3-encoded data, the generator-3 Galois element performs the
    stock-SEAL rotate_rows permutation (batchencoder.cpp:77-91 +
    galois generator 3); the fork's gen-5 keys do NOT."""
    ctx, keygen, enc, dec, ev, _ = setup
    bc = BatchEncoder(ctx, compat_gen3=True)
    tool = ctx.first_context_data().galois_tool
    elt3 = tool.get_elt_from_step(1, generator=3)
    gk = keygen.galois_keys([elt3])
    n = bc.slot_count
    row = n // 2
    vals = list(range(n))
    ct = enc.encrypt(bc.encode(vals))
    rot = ev.apply_galois(ct, elt3, gk)
    out = bc.decode(dec.decrypt(rot))
    expect = vals[1:row] + vals[:1] + vals[row + 1:] + vals[row:row + 1]
    assert out == expect


def test_encode_out_of_int64_range_raises_value_error(setup):
    """Values beyond int64 must raise the documented ValueError, not
    numpy's OverflowError (advisor round-2 finding)."""
    *_, be = setup
    with pytest.raises(ValueError, match="larger than plain_modulus"):
        be.encode([1 << 80])


def test_batch_encode_decode_batched(setup):
    """BatchEncoder.encode_batch/decode_batch == per-item paths."""
    *_, be = setup
    vecs = [list(range(10)), [5] * be.slot_count, [-3, 7, 0]]
    pts = be.encode_batch(vecs)
    for vec, pt in zip(vecs, pts):
        want = be.encode(vec)
        np.testing.assert_array_equal(np.asarray(pt.data), np.asarray(want.data))
    rows = be.decode_batch(pts, signed=True)
    for pt, row in zip(pts, rows):
        assert row == be.decode(pt, signed=True)
