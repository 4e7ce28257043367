"""Serialization round-trip tests + byte-level interop with the compiled
reference (reference: tests/seal/serialization.cpp and the object save/load
tests).  Interop tests skip when the oracle binary is absent
(build with tools/build_oracle.sh)."""

import os
import subprocess

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
from gemini_seal import serialization as ser

ORACLE = "/tmp/seal_oracle"
SEED = tuple(range(91, 99))


def make_ctx():
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(64)
    parms.set_coeff_modulus(CoeffModulus.create(64, [40, 40, 40]))
    parms.set_plain_modulus(257)
    parms.set_random_seed(SEED)
    return SealContext(parms, sec_level=SecLevelType.none), parms


def test_parms_roundtrip():
    _, parms = make_ctx()
    blob = ser.save(parms)
    loaded = ser.load_parms(blob)
    assert loaded.parms_id == parms.parms_id
    assert loaded.n_special_primes == parms.n_special_primes
    # deflate path
    blob_z = ser.save(parms, ser.COMPR_DEFLATE)
    assert ser.load_parms(blob_z).parms_id == parms.parms_id
    assert blob_z != blob


def test_ciphertext_roundtrip():
    ctx, _ = make_ctx()
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    dec = Decryptor(ctx, kg.secret_key)
    ct = enc.encrypt(Plaintext.from_hex("5x^3 + 4"))
    blob = ser.save(ct)
    loaded = ser.load_ciphertext(blob, ctx)
    assert loaded.parms_id == ct.parms_id
    assert np.array_equal(np.asarray(loaded.data), np.asarray(ct.data))
    assert dec.decrypt(loaded).to_hex() == "5x^3 + 4"
    # compressed
    blob_z = ser.save(ct, ser.COMPR_DEFLATE)
    assert len(blob_z) < len(blob)
    loaded_z = ser.load_ciphertext(blob_z, ctx)
    assert np.array_equal(np.asarray(loaded_z.data), np.asarray(ct.data))


def test_keys_roundtrip():
    ctx, _ = make_ctx()
    kg = KeyGenerator(ctx)
    sk_blob = ser.save(kg.secret_key)
    sk = ser.load_secret_key(sk_blob, ctx)
    assert np.array_equal(np.asarray(sk.data), np.asarray(kg.secret_key.data))

    rk = kg.relin_keys()
    rk_blob = ser.save(rk)
    rk2 = ser.load_relin_keys(rk_blob, ctx)
    assert rk2.parms_id == rk.parms_id
    assert len(rk2.keys) == len(rk.keys)
    for row1, row2 in zip(rk.keys, rk2.keys):
        for pk1, pk2 in zip(row1, row2):
            assert np.array_equal(np.asarray(pk1.data.data), np.asarray(pk2.data.data))

    # loaded keys still work
    enc = Encryptor(ctx, public_key=kg.public_key())
    dec = Decryptor(ctx, sk)
    ev = Evaluator(ctx)
    a = enc.encrypt(Plaintext.from_hex("3"))
    b = enc.encrypt(Plaintext.from_hex("4"))
    prod = ev.relinearize(ev.multiply(a, b), rk2)
    assert dec.decrypt(prod).to_hex().lower() == "c"


oracle_missing = not os.path.exists(ORACLE)


@pytest.mark.skipif(oracle_missing, reason="reference oracle not built")
class TestReferenceInterop:
    @pytest.fixture(scope="class")
    def vectors(self, tmp_path_factory):
        d = tmp_path_factory.mktemp("oracle")
        subprocess.run([ORACLE, "gen", str(d)], check=True, capture_output=True)
        return d

    def _ctx(self, d):
        parms = ser.load_parms((d / "parms.bin").read_bytes())
        return SealContext(parms, sec_level=SecLevelType.none)

    def test_load_reference_objects_and_decrypt(self, vectors):
        ctx = self._ctx(vectors)
        sk = ser.load_secret_key((vectors / "sk.bin").read_bytes(), ctx)
        ct1 = ser.load_ciphertext((vectors / "ct1.bin").read_bytes(), ctx)
        dec = Decryptor(ctx, sk)
        assert dec.decrypt(ct1).to_hex() == "3x^2 + 2"

    def test_evaluate_here_decrypt_there(self, vectors, tmp_path):
        ctx = self._ctx(vectors)
        ct1 = ser.load_ciphertext((vectors / "ct1.bin").read_bytes(), ctx)
        ct2 = ser.load_ciphertext((vectors / "ct2.bin").read_bytes(), ctx)
        ev = Evaluator(ctx)
        total = ev.add(ct1, ct2)
        out_path = tmp_path / "sum.bin"
        out_path.write_bytes(ser.save(total))
        res = subprocess.run(
            [ORACLE, "dec", str(vectors), str(out_path)],
            check=True, capture_output=True, text=True,
        )
        # (3x^2+2) + (2x+1) = 3x^2 + 2x + 3
        assert res.stdout.strip() == "3x^2 + 2x^1 + 3"

    def test_multiply_here_decrypt_there(self, vectors, tmp_path):
        ctx = self._ctx(vectors)
        ct1 = ser.load_ciphertext((vectors / "ct1.bin").read_bytes(), ctx)
        ct2 = ser.load_ciphertext((vectors / "ct2.bin").read_bytes(), ctx)
        ev = Evaluator(ctx)
        prod = ev.multiply(ct1, ct2)
        out_path = tmp_path / "prod.bin"
        out_path.write_bytes(ser.save(prod))
        res = subprocess.run(
            [ORACLE, "dec", str(vectors), str(out_path)],
            check=True, capture_output=True, text=True,
        )
        # (3x^2+2)(2x+1) = 6x^3 + 3x^2 + 4x + 2
        assert res.stdout.strip() == "6x^3 + 3x^2 + 4x^1 + 2"


@pytest.mark.skipif(oracle_missing, reason="reference oracle not built")
class TestPRNGParity:
    """Bit-exact randomness parity with the compiled reference: the full
    chain blake2xb -> RandomToStandardAdapter -> libstdc++ distribution
    algorithms -> samplers (-> NTT for the secret key)."""

    SEED = tuple(range(91, 99))

    def test_seeded_secret_key_bit_exact(self):
        parms = EncryptionParameters(SchemeType.BFV)
        parms.set_poly_modulus_degree(64)
        parms.set_coeff_modulus(CoeffModulus.create(64, [40, 40, 40]))
        parms.set_plain_modulus(257)
        parms.set_random_seed(self.SEED)
        ctx = SealContext(parms, sec_level=SecLevelType.none)
        sk = np.asarray(KeyGenerator(ctx).secret_key.data).reshape(-1)
        ref = subprocess.run(
            [ORACLE, "seededsk", "/tmp"], check=True, capture_output=True, text=True
        )
        assert [int(x, 16) for x in ref.stdout.split()] == [int(v) for v in sk]

    def test_seeded_gaussian_bit_exact(self):
        from gemini_seal.utils.blake2 import Blake2xbPRNG
        from gemini_seal.utils.prng import sample_poly_normal

        mods = [m.value for m in CoeffModulus.create(64, [40, 40, 40])]
        mine = sample_poly_normal(Blake2xbPRNG(self.SEED), mods, 64).reshape(-1)
        ref = subprocess.run(
            [ORACLE, "seedednoise", "/tmp"], check=True, capture_output=True, text=True
        )
        assert [int(x, 16) for x in ref.stdout.split()] == [int(v) for v in mine]


def test_seeded_symmetric_ciphertext_roundtrip():
    """Serializable<Ciphertext> equivalent: seed-compressed symmetric
    encryption saves at ~half size and decrypts after expansion
    (reference: serializable.h; rlwe.cpp:295-301 seed flow)."""
    ctx, parms = make_ctx()
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, secret_key=kg.secret_key)
    dec = Decryptor(ctx, kg.secret_key)

    pt = Plaintext.from_hex("5x^3 + 4x^1 + 3")
    sctx = enc.encrypt_symmetric_serializable(pt)
    blob = sctx.save()
    full_blob = ser.save(enc.encrypt_symmetric(pt))
    assert len(blob) < 0.6 * len(full_blob)

    ct = ser.load_ciphertext(blob, ctx)
    assert ct.size == 2
    out = dec.decrypt(ct)
    a = np.zeros(8, dtype=np.uint64)
    b = np.zeros(8, dtype=np.uint64)
    a[: np.asarray(out.data).shape[0]] = np.asarray(out.data)
    b[: np.asarray(pt.data).shape[0]] = np.asarray(pt.data)
    np.testing.assert_array_equal(a, b)


def test_seeded_ckks_symmetric_roundtrip():
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(64)
    parms.set_coeff_modulus(CoeffModulus.create(64, [40, 30, 40]))
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, secret_key=kg.secret_key)
    dec = Decryptor(ctx, kg.secret_key)

    from gemini_seal import CKKSEncoder

    encoder = CKKSEncoder(ctx)
    vals = [0.5, -1.25, 2.0]
    sct = enc.encrypt_symmetric_serializable(encoder.encode(vals, 2.0 ** 30))
    ct = ser.load_ciphertext(sct.save(), ctx)
    got = encoder.decode(dec.decrypt(ct))
    for g, w in zip(got[:3], vals):
        assert abs(g - w) < 1e-4


@pytest.mark.skipif(not os.path.exists(ORACLE), reason="reference oracle not built")
def test_seeded_encrypt_here_expand_there(tmp_path):
    """Our seed-compressed symmetric ciphertext must expand and decrypt in
    the C++ reference: validates the seeded wire format AND that our
    uniform sampler matches the reference's expand_seed bit-for-bit."""
    d = tmp_path / "o"
    d.mkdir()
    subprocess.run([ORACLE, "gen", str(d)], check=True, capture_output=True)
    parms = ser.load_parms((d / "parms.bin").read_bytes())
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    sk = ser.load_secret_key((d / "sk.bin").read_bytes(), ctx)

    enc = Encryptor(ctx, secret_key=sk)
    sct = enc.encrypt_symmetric_serializable(Plaintext.from_hex("6x^4 + 5"))
    blob_path = tmp_path / "seeded.bin"
    blob_path.write_bytes(sct.save())
    res = subprocess.run(
        [ORACLE, "dec", str(d), str(blob_path)],
        check=True, capture_output=True, text=True,
    )
    assert res.stdout.strip() == "6x^4 + 5"


@pytest.mark.skipif(not os.path.exists(ORACLE), reason="reference oracle not built")
def test_reference_keys_drive_our_keyswitch(tmp_path):
    """Relin/Galois keys generated by the C++ reference drive our hybrid
    key-switch: (a) multiply+relinearize decrypts to the squares in the
    reference itself; (b) apply_galois with the reference's key acts as the
    exact coefficient automorphism on the decrypted polynomial (checked at
    the poly level — the fork's own BatchEncoder/rotation generators are
    incoherent, see README deviation #2, so slot semantics can't be used).
    """
    d = tmp_path / "o"
    d.mkdir()
    subprocess.run([ORACLE, "genkeys", str(d)], check=True, capture_output=True)
    parms = ser.load_parms((d / "parms.bin").read_bytes())
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    sk = ser.load_secret_key((d / "sk.bin").read_bytes(), ctx)
    rk = ser.load_relin_keys((d / "rk.bin").read_bytes(), ctx)
    gk = ser.load_galois_keys((d / "gk.bin").read_bytes(), ctx)
    ct = ser.load_ciphertext((d / "ct_batch.bin").read_bytes(), ctx)

    ev = Evaluator(ctx)
    dec = Decryptor(ctx, sk)

    # (a) multiply + relinearize with THEIR keys, decrypt THERE
    sq = ev.relinearize(ev.multiply(ct, ct), rk)
    out_path = tmp_path / "sq.bin"
    out_path.write_bytes(ser.save(sq))
    res = subprocess.run(
        [ORACLE, "decbatch", str(d), str(out_path)],
        check=True, capture_output=True, text=True,
    )
    got = [int(x) for x in res.stdout.split()]
    want = [(i % 17) ** 2 % 257 for i in range(8)]
    assert got == want, (got, want)

    # (b) apply_galois with THEIR key == coefficient automorphism mod t
    n = 64
    t = 257
    tool = ctx.first_context_data().galois_tool
    elt = tool.get_elt_from_step(1)
    rot = ev.apply_galois(ct, elt, gk)
    base = np.zeros(n, dtype=np.int64)
    pdata = np.asarray(dec.decrypt(ct).data)
    base[: pdata.shape[0]] = pdata
    want_poly = np.zeros(n, dtype=np.int64)
    for i in range(n):
        raw = i * elt
        idx = raw % n
        sign = (raw // n) % 2
        want_poly[idx] = (-base[i]) % t if sign else base[i]
    got_poly = np.zeros(n, dtype=np.int64)
    gdata = np.asarray(dec.decrypt(rot).data)
    got_poly[: gdata.shape[0]] = gdata
    np.testing.assert_array_equal(got_poly, want_poly)


def test_seeded_encryption_reproducible_with_pinned_seed():
    """With parms.random_seed pinned, seeded encryption derives its c1 seed
    deterministically (like every other sampling path), so runs reproduce."""
    def one():
        ctx, _ = make_ctx()
        kg = KeyGenerator(ctx)
        enc = Encryptor(ctx, secret_key=kg.secret_key)
        a = enc.encrypt_symmetric_serializable(Plaintext.from_hex("7"))
        b = enc.encrypt_symmetric_serializable(Plaintext.from_hex("7"))
        return a.save(), b.save()

    a1, b1 = one()
    a2, b2 = one()
    assert a1 == a2 and b1 == b2   # reproducible across runs
    assert a1 != b1                # distinct seeds within a run


def test_native_framing_byte_identical():
    """The native runtime's SEALHeader framing (gst_native.cpp) must be
    byte-identical to the pure-Python path for both compression modes."""
    from gemini_seal.utils import native

    if not native.available():
        pytest.skip("native module not built")
    import struct
    import zlib

    payload = bytes(range(256)) * 37
    for compr, body in ((0, payload), (1, zlib.compress(payload))):
        py = struct.pack("<HBBBBHQ", 0xA15E, 0x10, 3, 5, compr, 0,
                         16 + len(body)) + body
        assert native.frame(payload, compr) == py
        assert native.unframe(py) [: len(payload)] == payload


def test_relin_galois_keys_roundtrip_ours():
    """RelinKeys/GaloisKeys save/load round-trips through our own wire
    path (KSwitchKeys format, kswitchkeys.cpp:43-150)."""
    ctx, _ = make_ctx()
    kg = KeyGenerator(ctx)
    rk = kg.relin_keys()
    gk = kg.galois_keys_from_steps([1, -1])

    rk2 = ser.load_relin_keys(ser.save(rk), ctx)
    assert len(rk2.keys) == len(rk.keys)
    for row_a, row_b in zip(rk.keys, rk2.keys):
        for pa, pb in zip(row_a, row_b):
            np.testing.assert_array_equal(
                np.asarray(pa.data.data), np.asarray(pb.data.data)
            )

    gk2 = ser.load_galois_keys(ser.save(gk, compr_mode=ser.COMPR_DEFLATE), ctx)
    # the reloaded keys must actually work
    enc = Encryptor(ctx, public_key=kg.public_key())
    dec = Decryptor(ctx, kg.secret_key)
    ev = Evaluator(ctx)
    ct = enc.encrypt(Plaintext.from_hex("2x^1 + 1"))
    tool = ctx.first_context_data().galois_tool
    elt = tool.get_elt_from_step(1)
    out = ev.apply_galois(ct, elt, gk2)
    assert dec.decrypt(out) is not None


@pytest.mark.skipif(not os.path.exists(ORACLE), reason="reference oracle not built")
def test_ckks_evaluate_here_decrypt_there(tmp_path):
    """CKKS interop: load the reference's CKKS ciphertext, evaluate here
    (double it), the reference decodes our result."""
    d = tmp_path / "o"
    d.mkdir()
    subprocess.run([ORACLE, "ckksgen", str(d)], check=True, capture_output=True)
    parms = ser.load_parms((d / "ckks_parms.bin").read_bytes())
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    ct = ser.load_ciphertext((d / "ckks_ct.bin").read_bytes(), ctx)

    ev = Evaluator(ctx)
    doubled = ev.add(ct, ct)
    out_path = tmp_path / "dbl.bin"
    out_path.write_bytes(ser.save(doubled))
    res = subprocess.run(
        [ORACLE, "ckksdec", str(d), str(out_path)],
        check=True, capture_output=True, text=True,
    )
    got = [float(v) for v in res.stdout.split()]
    want = [3.0, -4.5, 6.0, 0.25]  # 2 * {1.5, -2.25, 3.0, 0.125}
    assert all(abs(g - w) < 1e-4 for g, w in zip(got, want)), (got, want)


def test_native_unframe_rejects_malformed_total():
    """A crafted header with total < 16 must be rejected (the native path
    previously underflowed total-16 into a huge zlib source length)."""
    from gemini_seal.utils import native

    if not native.available():
        pytest.skip("native module not built")
    import struct

    bad = struct.pack("<HBBBBHQ", 0xA15E, 0x10, 3, 5, 1, 0, 5) + b"\x00" * 50
    with pytest.raises(ValueError):
        native.unframe(bad)


@pytest.mark.skipif(not os.path.exists(ORACLE), reason="oracle not built")
def test_batch_slot_semantics_cross_implementation(tmp_path):
    """Slot-LEVEL interop loop: the reference batch-
    encodes (generator-3 map), we rotate with the generator-3 Galois
    element under THEIR key, and the reference decodes the result — slots
    must come back row-rotated by one.  Also: their batch plaintext decodes
    here, slot-for-slot, via BatchEncoder(compat_gen3=True)."""
    from gemini_seal import BatchEncoder

    d = tmp_path / "o"
    d.mkdir()
    subprocess.run([ORACLE, "genkeys", str(d)], check=True, capture_output=True)
    parms = ser.load_parms((d / "parms.bin").read_bytes())
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    sk = ser.load_secret_key((d / "sk.bin").read_bytes(), ctx)
    gk3 = ser.load_galois_keys((d / "gk3.bin").read_bytes(), ctx)
    ct = ser.load_ciphertext((d / "ct_batch.bin").read_bytes(), ctx)
    dec = Decryptor(ctx, sk)
    ev = Evaluator(ctx)

    # (a) decode THEIR slot order HERE, slot-for-slot
    bc = BatchEncoder(ctx, compat_gen3=True)
    n = bc.slot_count
    vals = [i % 17 for i in range(n)]        # what the oracle encoded
    assert bc.decode(dec.decrypt(ct)) == vals

    # (b) rotate HERE with the gen-3 element and THEIR key, decode THERE
    tool = ctx.first_context_data().galois_tool
    elt3 = tool.get_elt_from_step(1, generator=3)
    assert gk3.has_key(elt3)
    rot = ev.apply_galois(ct, elt3, gk3)
    out_path = tmp_path / "rot.bin"
    out_path.write_bytes(ser.save(rot))
    res = subprocess.run(
        [ORACLE, "decbatch", str(d), str(out_path)],
        check=True, capture_output=True, text=True,
    )
    got = [int(x) for x in res.stdout.split()]
    row = n // 2
    expect_full = vals[1:row] + vals[:1] + vals[row + 1:] + vals[row:row + 1]
    assert got == expect_full[:8], (got, expect_full[:8])


def test_seal34_legacy_header_loads():
    """A SEAL 3.4 header ({magic u16, zero u8, compr u8, size u32,
    reserved u64}) upgrades on load exactly like the reference's
    LoadHeader(try_upgrade_if_invalid=true) path
    (serialization.cpp:137-165, serialization.h:305-334)."""
    import struct
    import zlib

    ctx, _ = make_ctx()
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    dec = Decryptor(ctx, kg.secret_key)
    ct = enc.encrypt(Plaintext.from_hex("5x^3 + 4"))
    modern = ser.save(ct, ser.COMPR_NONE)
    payload = modern[16:]

    legacy = struct.pack("<HBBIQ", 0xA15E, 0, 0, 16 + len(payload), 0) + payload
    loaded = ser.load_ciphertext(legacy, ctx)
    np.testing.assert_array_equal(np.asarray(loaded.data), np.asarray(ct.data))
    assert dec.decrypt(loaded).to_hex() == "5x^3 + 4"

    # deflate-mode legacy frame
    z = zlib.compress(payload)
    legacy_z = struct.pack("<HBBIQ", 0xA15E, 0, 1, 16 + len(z), 0) + z
    loaded_z = ser.load_ciphertext(legacy_z, ctx)
    np.testing.assert_array_equal(np.asarray(loaded_z.data), np.asarray(ct.data))

    # a genuinely invalid header still raises
    bad = struct.pack("<HBBBBHQ", 0xBEEF, 16, 3, 5, 0, 0, 16)
    with pytest.raises(ValueError):
        ser.load_ciphertext(bad + payload, ctx)


def test_seeded_kswitch_keys_roundtrip():
    """Seeded Serializable relin/Galois keys: half the wire size, load back
    bit-exact vs the expanded keys (reference: Serializable<RelinKeys>/
    <GaloisKeys>, keygenerator.h + serializable.h)."""
    ctx, _ = make_ctx()
    kg = KeyGenerator(ctx)

    srk = kg.relin_keys_serializable()
    blob = srk.save()
    rk = ser.load_relin_keys(blob, ctx)
    for row_a, row_b in zip(rk.keys, srk.obj.keys):
        for a, b in zip(row_a, row_b):
            np.testing.assert_array_equal(
                np.asarray(a.data.data), np.asarray(b.data.data)
            )
    # ~half the bytes of the expanded form
    full = ser.save(srk.obj)
    assert len(blob) < 0.6 * len(full), (len(blob), len(full))

    tool = ctx.first_context_data().galois_tool
    elts = [tool.get_elt_from_step(1), 2 * 64 - 1]
    sgk = kg.galois_keys_serializable(elts)
    gk = ser.load_galois_keys(sgk.save(), ctx)
    for elt in elts:
        assert gk.has_key(elt)
        for a, b in zip(gk.key(elt), sgk.obj.key(elt)):
            np.testing.assert_array_equal(
                np.asarray(a.data.data), np.asarray(b.data.data)
            )

    # and the expanded wrapper drives key switching like local keys
    kg2 = KeyGenerator(ctx)  # fresh ctx state irrelevant; same sk required
    enc = Encryptor(ctx, public_key=kg.public_key())
    dec = Decryptor(ctx, kg.secret_key)
    ev = Evaluator(ctx)
    ct = enc.encrypt(Plaintext.from_hex("3x^2 + 2"))
    sq = ev.relinearize(ev.multiply(ct, ct), rk)
    assert dec.decrypt(sq).to_hex() == dec.decrypt(
        ev.relinearize(ev.multiply(ct, ct), srk.obj)
    ).to_hex()


@pytest.mark.skipif(not os.path.exists(ORACLE), reason="oracle not built")
def test_seeded_relin_keys_expand_in_reference(tmp_path):
    """The compiled reference loads our seed-compressed RelinKeys blob,
    expands the c1 seeds through ITS BlakePRNG, and re-saves — the expanded
    bytes must equal our own expansion exactly."""
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(64)
    parms.set_coeff_modulus(CoeffModulus.create(64, [40, 40, 40]))
    parms.set_plain_modulus(257)
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    srk = kg.relin_keys_serializable()
    blob_path = tmp_path / "rk_seeded.bin"
    blob_path.write_bytes(srk.save())
    subprocess.run(
        [ORACLE, "expandrelin", str(tmp_path), str(blob_path)],
        check=True, capture_output=True,
    )
    ref_expanded = (tmp_path / "rk_expanded.bin").read_bytes()
    theirs = ser.load_relin_keys(ref_expanded, ctx)
    for row_a, row_b in zip(theirs.keys, srk.obj.keys):
        for a, b in zip(row_a, row_b):
            np.testing.assert_array_equal(
                np.asarray(a.data.data), np.asarray(b.data.data)
            )


# ---------------------------------------------------------------------------
# Streaming / bounded-stream surface (reference: serialization.h:211-278)
# ---------------------------------------------------------------------------

def test_save_size_exact_and_bound():
    """save_size is EXACT for COMPR_NONE (no payload materialization) and
    an upper bound for deflate, for every object kind."""
    ctx, parms = make_ctx()
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    ct = enc.encrypt(Plaintext.from_hex("5x^3 + 4"))
    rk = kg.relin_keys()
    gk = kg.galois_keys([3])
    objs = [parms, parms.coeff_modulus[0], kg.secret_key, kg.public_key(),
            Plaintext.from_hex("2x^1 + 1"), ct, rk, gk]
    for obj in objs:
        blob = ser.save(obj)
        assert ser.save_size(obj) == len(blob), type(obj)
        blob_z = ser.save(obj, ser.COMPR_DEFLATE)
        assert ser.save_size(obj, ser.COMPR_DEFLATE) >= len(blob_z), type(obj)


def test_stream_multi_object_bounded():
    """Several objects saved back to back into ONE stream load back in
    order, each read consuming exactly its framed bytes (the bounded-
    stream property); trailing bytes stay unread."""
    import io

    ctx, parms = make_ctx()
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    dec = Decryptor(ctx, kg.secret_key)
    ct = enc.encrypt(Plaintext.from_hex("5x^3 + 4"))
    rk = kg.relin_keys()

    buf = io.BytesIO()
    n1 = ser.save_to(parms, buf)
    n2 = ser.save_to(ct, buf, ser.COMPR_DEFLATE)
    n3 = ser.save_to(rk, buf)
    buf.write(b"TRAILING")
    assert n1 == ser.save_size(parms)

    buf.seek(0)
    p2 = ser.load_parms_from(buf)
    assert p2.parms_id == parms.parms_id
    ct2 = ser.load_ciphertext_from(buf, ctx)
    assert np.array_equal(np.asarray(ct2.data), np.asarray(ct.data))
    rk2 = ser.load_relin_keys_from(buf, ctx)
    got = dec.decrypt(Evaluator(ctx).relinearize(
        Evaluator(ctx).multiply(ct, ct), rk2))
    want = dec.decrypt(Evaluator(ctx).relinearize(
        Evaluator(ctx).multiply(ct, ct), rk))
    assert got.to_hex() == want.to_hex()
    assert buf.read() == b"TRAILING"


def test_read_framed_rejects_truncation():
    import io

    ctx, parms = make_ctx()
    blob = ser.save(parms)
    with pytest.raises(ValueError, match="invalid"):
        ser.read_framed(io.BytesIO(blob[:10]))
    with pytest.raises(ValueError, match="invalid"):
        ser.read_framed(io.BytesIO(blob[:-4]))


def test_save_size_serializable_objects():
    """save_size covers the seed-compressed wrappers exactly (the
    largest objects shipped to a serving accelerator)."""
    import io

    ctx, parms = make_ctx()
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, secret_key=kg.secret_key)
    sct = enc.encrypt_symmetric_serializable(Plaintext.from_hex("2x^1 + 1"))
    srk = kg.relin_keys_serializable()
    for obj in (sct, srk):
        blob = obj.save()
        assert ser.save_size(obj) == len(blob), type(obj)
        assert ser.save_size(obj, ser.COMPR_DEFLATE) >= len(
            obj.save(ser.COMPR_DEFLATE)
        )
        buf = io.BytesIO()
        n = ser.save_to(obj, buf)
        assert n == len(blob) and buf.getvalue() == blob


def test_loader_rejects_corrupted_blobs_cleanly():
    """Failure-detection fuzz: byte-flipped, truncated, and garbage wire
    blobs must raise clean Python exceptions (ValueError family or the
    zlib/struct decode errors) — never crash, hang, or return a
    ciphertext that silently passes validation."""
    import zlib

    from gemini_seal import CKKSEncoder

    parms = EncryptionParameters(SchemeType.CKKS)
    n = 64
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [40, 30, 40]))
    parms.set_random_seed(tuple(range(8)))
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    ct = enc.encrypt(encoder.encode([0.5, -1.0], 2.0 ** 30))

    ok_errors = (ValueError, TypeError, EOFError, OverflowError,
                 MemoryError, IndexError, zlib.error)
    rng = np.random.default_rng(99)
    for compr in (ser.COMPR_NONE, ser.COMPR_DEFLATE):
        blob = ser.save(ct, compr)
        # single-byte flips across the blob (header, metadata, payload)
        for off in sorted(rng.choice(len(blob), size=24, replace=False)):
            bad = bytearray(blob)
            bad[off] ^= 0xFF
            try:
                out = ser.load_ciphertext(bytes(bad), ctx)
                # a flip deep in ciphertext DATA can decode to residues
                # that still pass range checks — that is fine (the values
                # decrypt to noise); metadata integrity is what matters
                assert out.data.shape == np.asarray(ct.data).shape
            except ok_errors:
                pass
        # truncations at every region boundary and a few interior points
        for cut in [0, 1, 7, 15, 16, 17, len(blob) // 2, len(blob) - 1]:
            try:
                ser.load_ciphertext(blob[:cut], ctx)
                raise AssertionError(f"truncated blob (cut={cut}) loaded")
            except ok_errors:
                pass
        # random garbage of plausible sizes
        for size in (0, 16, 256):
            try:
                ser.load_ciphertext(rng.bytes(size), ctx)
                raise AssertionError("garbage blob loaded")
            except ok_errors:
                pass


def _fuzz_loader(load_fn, blob, rng, ok_errors, tolerate_decode=False):
    """Shared corpus: byte flips at random offsets, truncations at region
    boundaries, and random garbage.  Loaders must raise clean exceptions
    (or, when tolerate_decode, return a structurally-valid object for
    payload-deep flips) — never crash or hang."""
    for off in sorted(rng.choice(len(blob), size=24, replace=False)):
        bad = bytearray(blob)
        bad[off] ^= 0xFF
        try:
            load_fn(bytes(bad))
            if not tolerate_decode:
                # a payload-deep flip may still decode for value-only
                # objects; metadata-validated loaders must reject most —
                # reaching here is acceptable ONLY if the loader validated
                pass
        except ok_errors:
            pass
    for cut in [0, 1, 7, 15, 16, 17, len(blob) // 2, len(blob) - 1]:
        try:
            load_fn(blob[:cut])
            raise AssertionError(f"truncated blob (cut={cut}) loaded")
        except ok_errors:
            pass
    for size in (0, 16, 256):
        try:
            load_fn(rng.bytes(size))
            raise AssertionError("garbage blob loaded")
        except ok_errors:
            pass


def test_kswitch_and_parms_loaders_reject_corruption():
    """Extend the round-3 ciphertext fuzz to the
    kswitch-keys loader (relin + Galois), the parms loader, and the
    seed-compressed Serializable wrappers."""
    import zlib

    ok_errors = (ValueError, TypeError, EOFError, OverflowError,
                 MemoryError, IndexError, KeyError, zlib.error)
    ctx, parms = make_ctx()
    kg = KeyGenerator(ctx)
    rng = np.random.default_rng(7)

    rk_blob = ser.save(kg.relin_keys())
    _fuzz_loader(lambda b: ser.load_relin_keys(b, ctx), rk_blob, rng,
                 ok_errors)

    elt = ctx.first_context_data().galois_tool.get_elt_from_step(1)
    gk_blob = ser.save(kg.galois_keys([elt]))
    _fuzz_loader(lambda b: ser.load_galois_keys(b, ctx), gk_blob, rng,
                 ok_errors)

    parms_blob = ser.save(parms)
    _fuzz_loader(ser.load_parms, parms_blob, rng, ok_errors)

    # seed-compressed Serializable wrappers: the seeded-c1 marker and the
    # PRNG seed live in the payload; loads must stay clean under the
    # same corpus, and intact seeded blobs must still expand
    enc = Encryptor(ctx, secret_key=kg.secret_key)
    sct = enc.encrypt_symmetric_serializable(Plaintext.from_hex("2x^1 + 1"))
    sct_blob = sct.save()
    assert ser.load_ciphertext(sct_blob, ctx) is not None
    _fuzz_loader(lambda b: ser.load_ciphertext(b, ctx), sct_blob, rng,
                 ok_errors)

    srk_blob = kg.relin_keys_serializable().save()
    assert ser.load_relin_keys(srk_blob, ctx) is not None
    _fuzz_loader(lambda b: ser.load_relin_keys(b, ctx), srk_blob, rng,
                 ok_errors)


def test_native_unframe_matches_python_fallback():
    """gst_unframe (native/gst_native.cpp) must agree with the Python
    _unframe on the SAME corpus: identical payload on valid 3.5 frames,
    and both-reject on corrupted ones.  (The native path does not
    implement the SEAL-3.4 legacy-header upgrade — Python-only by
    design — so the corpus here is 3.5 frames.)"""
    import zlib

    from gemini_seal.utils import native

    if not native.available():
        pytest.skip("native module unavailable")

    rng = np.random.default_rng(17)
    ok_errors = (ValueError, zlib.error)
    payloads = [b"", b"x", rng.bytes(100), rng.bytes(5000)]
    for payload in payloads:
        for compr in (ser.COMPR_NONE, ser.COMPR_DEFLATE):
            blob = ser._frame(payload, compr)
            py, _ = ser._unframe(blob)
            nat = native.unframe(blob)
            assert py == payload and nat == payload

            # corrupt: flips across header and payload
            offsets = set(range(min(16, len(blob)))) | {
                int(o) for o in rng.choice(len(blob), size=8)
            }
            for off in sorted(offsets):
                bad = bytes(
                    b ^ (0xFF if i == off else 0) for i, b in enumerate(blob)
                )
                try:
                    py_out = ser._unframe(bad)[0]
                    py_raised = False
                except ok_errors:
                    py_raised = True
                try:
                    nat_out = native.unframe(bad)
                    nat_raised = False
                except ok_errors:
                    nat_raised = True
                if py_raised != nat_raised:
                    # the ONLY tolerated divergence: a flip that turns the
                    # header-size byte into the legacy-3.4 marker (0),
                    # which Python upgrades and native rejects
                    assert off == 2 and not py_raised and nat_raised, off
                elif not py_raised:
                    assert py_out == nat_out, off
            # truncations
            for cut in (0, 5, 15, 16, max(16, len(blob) - 3)):
                bad = blob[:cut]
                try:
                    py_out = ser._unframe(bad)[0]
                    py_raised = False
                except ok_errors:
                    py_raised = True
                try:
                    nat_out = native.unframe(bad)
                    nat_raised = False
                except ok_errors:
                    nat_raised = True
                assert py_raised == nat_raised, cut
                if not py_raised:
                    assert py_out == nat_out, cut
