"""Host number-theory tests.

Pinned values come from the reference's behavior (numth.cpp, modulus.cpp) —
e.g. get_primes' descending scan and the minimal primitive root of the
60-bit NTT test prime (tests/seal/util/ntt.cpp uses 0xffffffffffc0001).
"""

from gemini_seal.utils import numth
from gemini_seal.modulus import CoeffModulus, Modulus, PlainModulus, SecLevelType


def test_is_prime():
    assert numth.is_prime(2)
    assert numth.is_prime(0xFFFFFFFFFFC0001)
    assert numth.is_prime(0x7E00001)
    assert not numth.is_prime(1)
    assert not numth.is_prime(0xFFFFFFFFFFC0000)
    assert not numth.is_prime((1 << 60) - 1)


def test_get_primes_descending_congruent():
    primes = numth.get_primes(4096, 40, 3)
    assert len(primes) == 3
    for p in primes:
        assert numth.is_prime(p)
        assert p % 8192 == 1
        assert p.bit_length() == 40
    assert primes == sorted(primes, reverse=True)


def test_minimal_primitive_root():
    # 0xffffffffffc0001 supports NTT up to n = 2^?? ; check basic identity
    p = 0xFFFFFFFFFFC0001
    for n in (64, 4096):
        root = numth.try_minimal_primitive_root(2 * n, p)
        assert root is not None
        assert pow(root, n, p) == p - 1  # primitive: root^n = -1
        assert pow(root, 2 * n, p) == 1
        # minimality: root^k for odd k are the other primitive roots
        g = pow(root, 3, p)
        assert g >= root or g == root


def test_reverse_bits():
    assert numth.reverse_bits(0b001, 3) == 0b100
    assert numth.reverse_bits(0b110, 3) == 0b011
    assert numth.reverse_bits(1, 1) == 1


def test_invert():
    p = 0xFFFFFFFFFFC0001
    for v in (2, 12345, p - 1):
        inv = numth.try_invert_uint_mod(v, p)
        assert (v * inv) % p == 1
    assert numth.try_invert_uint_mod(0, p) is None


def test_naf():
    for v in (0, 1, 7, 13, -5, 31, 123456):
        assert sum(numth.naf(v)) == v
    # NAF has no adjacent nonzero digits
    terms = numth.naf(7)  # 8 - 1
    assert sorted(map(abs, terms)) == [1, 8]


def test_modulus_const_ratio():
    m = Modulus(0xFFFFFFFFFFC0001)
    lo, hi, rem = m.const_ratio
    q = (hi << 64) | lo
    assert q == (1 << 128) // m.value
    assert rem == (1 << 128) % m.value
    assert m.is_prime
    assert m.bit_count == 60


def test_coeff_modulus_factories():
    default = CoeffModulus.bfv_default(4096)
    assert [m.value for m in default] == [0xFFFFEE001, 0xFFFFC4001, 0x1FFFFE0001]
    assert CoeffModulus.max_bit_count(8192) == 218
    assert CoeffModulus.max_bit_count(8192, SecLevelType.tc192) == 152

    # quantum budgets (reference hestdparms.h:81-144 *_TQ tables, pinned
    # against the header values; dead code upstream — see modulus.py note)
    assert CoeffModulus.max_bit_count_quantum(8192) == 202
    assert CoeffModulus.max_bit_count_quantum(1024) == 25
    assert CoeffModulus.max_bit_count_quantum(32768) == 827
    assert CoeffModulus.max_bit_count_quantum(8192, SecLevelType.tc192) == 141
    assert CoeffModulus.max_bit_count_quantum(16384, SecLevelType.tc192) == 284
    assert CoeffModulus.max_bit_count_quantum(8192, SecLevelType.tc256) == 109
    assert CoeffModulus.max_bit_count_quantum(32768, SecLevelType.tc256) == 443
    assert CoeffModulus.max_bit_count_quantum(512) == 0  # off-table, like tc

    created = CoeffModulus.create(4096, [40, 40, 40])
    assert len(created) == 3
    assert len({m.value for m in created}) == 3
    for m in created:
        assert m.value % 8192 == 1 and m.is_prime

    t = PlainModulus.batching(4096, 20)
    assert t.value % 8192 == 1 and t.is_prime
