"""Vectorized multiprecision limb-plane arithmetic and the exact CKKS
encode/decode paths built on it.

Pins the vectorized implementations bit-exactly against per-coefficient
Python big-int models (the round-2 implementations, which themselves were
oracle-verified against the compiled reference).
"""

import math

import numpy as np
import pytest

from gemini_seal import (
    CKKSEncoder,
    CoeffModulus,
    EncryptionParameters,
    SchemeType,
    SecLevelType,
    SealContext,
)
from gemini_seal.utils import mplimb
from gemini_seal.utils.rns import RNSBase


@pytest.fixture(scope="module")
def base():
    # 4-limb 50-bit base -> ~200-bit q exercises multi-word carries
    return RNSBase(CoeffModulus.create(1 << 12, [50, 50, 50, 50]))


def test_int_limbs_roundtrip():
    vals = [0, 1, (1 << 64) - 1, 1 << 64, (1 << 190) + 12345]
    for v in vals:
        limbs = mplimb.int_to_limbs(v, 4)
        back = mplimb.limbs_to_ints(limbs[:, None])[0]
        assert back == v
    with pytest.raises(ValueError):
        mplimb.int_to_limbs(1 << 200, 3)


def test_compose_limbs_matches_python_crt(base):
    rng = np.random.default_rng(7)
    n = 257  # odd length: no shape assumptions
    residues = np.stack(
        [rng.integers(0, base[j].value, n, dtype=np.uint64) for j in range(base.size)]
    )
    limbs = mplimb.compose_limbs(residues, base)
    got = mplimb.limbs_to_ints(limbs)
    for k in range(n):
        want = base.compose([int(residues[j, k]) for j in range(base.size)])
        assert got[k] == want


def test_compose_limbs_extremes(base):
    # all-zero and all-(q_j - 1) columns
    residues = np.zeros((base.size, 2), dtype=np.uint64)
    for j in range(base.size):
        residues[j, 1] = base[j].value - 1
    got = mplimb.limbs_to_ints(mplimb.compose_limbs(residues, base))
    assert got[0] == 0
    want = base.compose([base[j].value - 1 for j in range(base.size)])
    assert got[1] == want


def test_geq_and_masked_sub():
    a = np.array([[5, 0, 7], [1, 1, 1]], dtype=np.uint64)  # 2-limb, 3 vals
    b = np.array([[6], [1]], dtype=np.uint64)  # constant 2^64 + 6
    geq = mplimb.geq_limbs(a, b)
    assert list(geq) == [False, False, True]
    mplimb.sub_limbs_masked(a, b, geq)
    assert a[0, 2] == 1 and a[1, 2] == 0  # (2^64+7) - (2^64+6) = 1
    assert a[0, 0] == 5 and a[1, 0] == 1  # untouched


def test_ladder_matches_python_ladder():
    rng = np.random.default_rng(3)
    k, n = 4, 64
    limbs = rng.integers(0, 1 << 63, (k, n), dtype=np.uint64)
    limbs[2:, : n // 2] = 0  # exercise zero high words
    unit = 1.0 / 2.0 ** 40
    got = mplimb.ladder_to_double(limbs, unit)
    for i in range(n):
        acc, scaled = 0.0, unit
        x = mplimb.limbs_to_ints(limbs[:, i : i + 1])[0]
        while x:
            acc += float(x & 0xFFFFFFFFFFFFFFFF) * scaled
            scaled *= 2.0 ** 64
            x >>= 64
        assert got[i] == acc


@pytest.fixture(scope="module")
def ckks():
    parms = EncryptionParameters(SchemeType.CKKS)
    n = 512
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [50, 50, 50, 50]))
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    return ctx, CKKSEncoder(ctx)


def _decode_slow(encoder, ctx, plain, as_complex=False):
    """The round-2 per-coefficient decode (oracle-verified) as the model."""
    from gemini_seal.ops.ntt import ntt_inverse

    cd = ctx.get_context_data(plain.parms_id)
    n = cd.parms.poly_modulus_degree
    inv_scale = 1.0 / plain.scale
    data = np.asarray(
        ntt_inverse(np.asarray(plain.data, dtype=np.uint64), cd.ntt_tables),
        dtype=np.uint64,
    )
    big = [
        cd.rns_base.compose([int(data[j, i]) for j in range(cd.rns_base.size)])
        for i in range(n)
    ]
    q = cd.total_coeff_modulus
    upper_half = cd.upper_half_threshold
    res = np.zeros(n, dtype=np.complex128)
    for i in range(n):
        v = big[i]
        acc = 0.0
        if v >= upper_half:
            scaled = inv_scale
            x = q - v
            while x:
                acc -= float(x & 0xFFFFFFFFFFFFFFFF) * scaled
                scaled *= 2.0 ** 64
                x >>= 64
        else:
            scaled = inv_scale
            x = v
            while x:
                acc += float(x & 0xFFFFFFFFFFFFFFFF) * scaled
                scaled *= 2.0 ** 64
                x >>= 64
        res[i] = acc
    res = encoder._embedding_forward(res)
    out = [res[encoder._index_map[i]] for i in range(encoder.slots)]
    if as_complex:
        return [complex(v) for v in out]
    return [float(v.real) for v in out]


def test_decode_bit_exact_vs_slow_model_high_scale(ckks):
    """>52-bit coefficients (scale 2^120) with negative values: the
    vectorized centered ladder must equal the per-coefficient model
    bit for bit."""
    ctx, encoder = ckks
    rng = np.random.default_rng(11)
    scale = 2.0 ** 120
    vals = (rng.standard_normal(encoder.slot_count)
            + 1j * rng.standard_normal(encoder.slot_count))
    pt = encoder.encode(list(vals), scale)
    fast = encoder.decode(pt, as_complex=True)
    slow = _decode_slow(encoder, ctx, pt, as_complex=True)
    assert all(f == s for f, s in zip(fast, slow))


def test_encode_big_regime_bit_exact_vs_decompose(ckks):
    """The mantissa-split residue path must equal per-coefficient
    big-int decomposition exactly (reference regimes, ckks.h:514-607)."""
    ctx, encoder = ckks
    cd = ctx.first_context_data()
    rng = np.random.default_rng(13)
    # mix of small, large-positive, large-negative, zero
    reals = np.concatenate([
        rng.integers(-1000, 1000, 128).astype(np.float64),
        (rng.standard_normal(128) * 2.0 ** 130),
        np.zeros(64),
        rng.standard_normal(192) * 2.0 ** 75,
    ])
    dest = encoder._round_and_decompose(reals, cd, 140)
    rounded = np.sign(reals) * np.floor(np.abs(reals) + 0.5)
    for i in range(0, reals.size, 17):
        coeffd = float(rounded[i])
        neg = math.copysign(1.0, coeffd) < 0
        coeffu = int(abs(coeffd))
        residues = cd.rns_base.decompose(coeffu)
        for j, mod in enumerate(cd.parms.coeff_modulus):
            want = (mod.value - residues[j]) % mod.value if neg else residues[j]
            assert int(dest[j, i]) == want, (i, j)


def test_encode_decode_roundtrip_high_scale(ckks):
    ctx, encoder = ckks
    vals = [1.25, -3.5, 1e10, -2.75e12]
    pt = encoder.encode(vals, 2.0 ** 110)
    out = encoder.decode(pt)
    for got, want in zip(out[:4], vals):
        assert abs(got - want) < 1e-3 * max(1.0, abs(want))


def test_compose_array_vectorized(base):
    rng = np.random.default_rng(5)
    residues = np.stack(
        [rng.integers(0, base[j].value, 33, dtype=np.uint64) for j in range(base.size)]
    )
    got = base.compose_array(residues)
    for k in (0, 7, 32):
        want = base.compose([int(residues[j, k]) for j in range(base.size)])
        assert got[k] == want


def test_encode_at_base_high_scale_matches_ct_base(ckks):
    """encode_at_base residues at an EXTENDED base must be the residues of
    the SAME rounded integers encode() produces — including the >52-bit
    mantissa-split regime (native fast path with a fresh pow2 table)."""
    ctx, encoder = ckks
    from gemini_seal.modulus import Modulus
    from gemini_seal.ops.keyswitch import KeySwitchPlan
    from gemini_seal.ops.ntt import ntt_inverse

    plan = KeySwitchPlan(ctx, ctx.first_parms_id)
    ext_mods = [Modulus(p) for p in plan.ext_moduli]
    scale = 2.0 ** 80
    vals = [1.5, -2.25, 3.5e6, -7.75]
    ext = encoder.encode_at_base(vals, scale, ctx.first_parms_id,
                                 ext_mods, plan.ext_tables)
    ext_power = np.asarray(ntt_inverse(ext, plan.ext_tables), dtype=np.uint64)

    # reconstruct the signed integers from the ct-base encode() and check
    # every extended-row residue
    pt = encoder.encode(vals, scale)
    cd = ctx.first_context_data()
    data = np.asarray(ntt_inverse(np.asarray(pt.data), cd.ntt_tables),
                      dtype=np.uint64)
    big = cd.rns_base.compose_array(data)
    q = cd.total_coeff_modulus
    half = cd.upper_half_threshold
    for i in range(0, cd.parms.poly_modulus_degree, 37):
        v = big[i]
        if v >= half:
            v -= q
        for j, m in enumerate(ext_mods):
            assert int(ext_power[j, i]) == v % m.value, (i, j)


def test_decode_batch_matches_per_plain(ckks):
    """CKKSEncoder.decode_batch == per-plaintext decode (incl. the
    batched embedding FFT and the flattened compose)."""
    ctx, encoder = ckks
    rng = np.random.default_rng(23)
    scale = 2.0 ** 80
    pts = [
        encoder.encode(list(rng.standard_normal(encoder.slot_count)), scale)
        for _ in range(3)
    ]
    batched = encoder.decode_batch(pts)
    batched_c = encoder.decode_batch(pts, as_complex=True)
    for pt, row, row_c in zip(pts, batched, batched_c):
        assert row == encoder.decode(pt)
        assert row_c == encoder.decode(pt, as_complex=True)


def test_encode_batch_matches_per_vector(ckks):
    """CKKSEncoder.encode_batch == per-vector encode bit for bit (incl.
    the >52-bit regime), for real and complex inputs."""
    ctx, encoder = ckks
    rng = np.random.default_rng(29)
    scale = 2.0 ** 80
    vecs = [
        list(rng.standard_normal(encoder.slot_count)),
        [1.5, -2.5, 3.0],
        [complex(0.5, -1.0), complex(-2.0, 0.25)],
    ]
    batch = encoder.encode_batch(vecs, scale)
    for vec, pt in zip(vecs, batch):
        want = encoder.encode(vec, scale)
        np.testing.assert_array_equal(np.asarray(pt.data), np.asarray(want.data))
        assert pt.scale == want.scale and pt.parms_id == want.parms_id


def test_crt_centered_double_native_bit_exact(base):
    """The fused native decode ladder (gst_crt_centered_double) is
    bit-exact with the limb-plane path on random and extreme residues."""
    from gemini_seal.utils import native as _native

    if not _native.available():
        pytest.skip("native module not built")
    L = base.size
    n = 257
    q = base.base_prod
    K = max(1, (q.bit_length() + 63) // 64)
    rng = np.random.default_rng(17)
    residues = np.stack([
        rng.integers(0, int(base[j].value), size=n, dtype=np.uint64)
        for j in range(L)
    ])
    # plant extremes: 0, q-1, (q+1)//2 (the centered-lift tie), and
    # (q+1)//2 - 1 (the largest positive)
    for col, v in enumerate([0, q - 1, (q + 1) // 2, (q + 1) // 2 - 1]):
        for j in range(L):
            residues[j, col] = v % int(base[j].value)

    inv_scale = 1.0 / 2.0**40
    consts = mplimb.native_compose_consts(base, K)
    upper = mplimb.int_to_limbs((q + 1) // 2, K)
    got = _native.crt_centered_double(
        residues, consts[1], consts[2], consts[3], consts[4], upper, K,
        inv_scale)

    v_limbs = mplimb.compose_limbs(residues, base)
    is_neg = mplimb.geq_limbs(v_limbs, upper[:, None])
    neg_mag = mplimb.sub_from_limbs(mplimb.int_to_limbs(q, K)[:, None],
                                    v_limbs)
    mag = np.where(is_neg[None, :], neg_mag, v_limbs)
    want = np.where(is_neg, -mplimb.ladder_to_double(mag, inv_scale),
                    mplimb.ladder_to_double(mag, inv_scale))
    np.testing.assert_array_equal(got, want)
