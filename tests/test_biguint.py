"""BigUInt API parity tests (reference: native/tests/seal/biguint.cpp)."""

from gemini_seal import BigUInt


def test_ctor_and_hex():
    z = BigUInt()
    assert z.is_zero() and z.bit_count == 0 and z.to_string() == "0"
    h = BigUInt("ABCD1234")
    assert int(h) == 0xABCD1234
    assert h.to_string() == "ABCD1234"
    w = BigUInt(5, bit_count=70)
    assert w.uint64_count == 2 and w.byte_count == 9
    assert w.significant_bit_count() == 3


def test_arithmetic_wraps():
    a = BigUInt(0xFF, 8)
    b = BigUInt(1, 8)
    assert int(a + b) == 0          # wraps mod 2^8
    assert int(a * BigUInt(2, 8)) == 0xFE
    assert int(a - b) == 0xFE
    q, r = BigUInt(100, 8).divrem(7)
    assert (int(q), int(r)) == (14, 2)


def test_modinv_pow():
    a = BigUInt(3)
    inv = a.modinv(65537)
    assert (3 * int(inv)) % 65537 == 1
    assert int(BigUInt(2).trypow(10, 1000)) == 24


def test_save_load_roundtrip():
    v = BigUInt((1 << 100) + 12345, 128)
    blob = v.save()
    assert len(blob) == 16
    back = BigUInt.load(blob, 128)
    assert back == v and back.bit_count == 128


def test_resize():
    v = BigUInt(0x1FF, 9)
    v.resize(8)
    assert int(v) == 0xFF and v.bit_count == 8
