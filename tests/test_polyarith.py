"""Generic big-coefficient poly arithmetic (reference:
tests/seal/util/polyarith.cpp style — exact expected values, including
multi-word coefficients)."""

from gemini_seal.utils.polyarith import (
    add_poly,
    multiply_poly,
    negate_poly,
    poly_eval_poly,
    poly_infty_norm,
    right_shift_poly_coeffs,
    sub_poly,
)

BIG = (1 << 100) + 12345  # multi-uint64 coefficient


def test_shift_negate():
    assert right_shift_poly_coeffs([8, BIG], 3) == [1, BIG >> 3]
    # 128-bit two's complement
    assert negate_poly([1, 0, BIG], 128) == [
        (1 << 128) - 1, 0, (1 << 128) - BIG
    ]
    # double negation is identity
    assert negate_poly(negate_poly([7, BIG], 128), 128) == [7, BIG]


def test_add_sub_wrap():
    w = 128
    m = (1 << w) - 1
    a = [m, 5, BIG]
    b = [1, 7]
    assert add_poly(a, b, w) == [0, 12, BIG]          # carry discarded
    assert sub_poly(b, a, w) == [2, 2, ((1 << w) - BIG)]
    assert sub_poly(add_poly(a, b, w), b, w) == a


def test_multiply_exact():
    # (1 + 2x)(3 + x) = 3 + 7x + 2x^2, exact also with big coefficients
    assert multiply_poly([1, 2], [3, 1]) == [3, 7, 2]
    out = multiply_poly([BIG, 1], [BIG])
    assert out == [BIG * BIG, BIG]
    assert multiply_poly([1, 2, 3], [1], result_coeff_count=5) == [1, 2, 3, 0, 0]


def test_norm_and_eval():
    assert poly_infty_norm([3, BIG, 7]) == BIG
    assert poly_infty_norm([]) == 0
    # p(y) = 1 + 2y + y^2 at y = x + 1: (x+2)^2 = x^2 + 4x + 4
    assert poly_eval_poly([1, 2, 1], [1, 1]) == [4, 4, 1]
    # constant evaluation
    assert poly_eval_poly([5], [123, 456]) == [5]
