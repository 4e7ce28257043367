"""Exact algebraic tests for the RNS machinery, mirroring the reference's
unit suite (reference: native/tests/seal/util/rns.cpp:204-994):
RNSBase compose/decompose, BaseConverter matrices, and every RNSTool
primitive — fastbconv_m_tilde, sm_mrq (Montgomery reduction), fast_floor,
fastbconv_sk, decrypt_scale_and_round, divide_and_round_q_last[_ntt].

Where the reference checks hand-picked scalars, these tests verify the
defining algebraic identity on random vectors with exact Python integers —
a strictly stronger check with the same coverage.
"""

import numpy as np
import pytest

from gemini_seal.modulus import Modulus
from gemini_seal.ops.dyadic import LimbConstants
from gemini_seal.ops.ntt import build_ntt_tables, ntt_forward, ntt_inverse
from gemini_seal.ops import rnsops
from gemini_seal.ops.rnsops import (
    DeviceRNSTool,
    decrypt_scale_and_round,
    divide_and_round_q_last,
    divide_and_round_q_last_ntt,
    fast_convert_array,
    fast_floor,
    fastbconv_m_tilde,
    fastbconv_sk,
    sm_mrq,
)
from gemini_seal.utils.numth import get_primes
from gemini_seal.utils.rns import BaseConverter, RNSBase, RNSTool

RNG = np.random.default_rng(12345)


# ---------------------------------------------------------------------------
# RNSBase (reference: tests/seal/util/rns.cpp:204-276)
# ---------------------------------------------------------------------------

def test_rnsbase_compose_decompose_roundtrip():
    base = RNSBase([3, 5, 7, 11])
    total = 3 * 5 * 7 * 11
    for v in [0, 1, 2, total - 1, total // 2, 1000 % total]:
        res = base.decompose(v)
        assert res == [v % 3, v % 5, v % 7, v % 11]
        assert base.compose(res) == v


def test_rnsbase_big_primes_roundtrip():
    primes = get_primes(1 << 10, 60, 4)
    base = RNSBase(primes)
    total = 1
    for p in primes:
        total *= int(p)
    for _ in range(20):
        v = int(RNG.integers(0, 2 ** 63)) * int(RNG.integers(0, 2 ** 63))
        v %= total
        assert base.compose(base.decompose(v)) == v


def test_rnsbase_extend_drop():
    base = RNSBase([3, 5])
    ext = base.extend(7)
    assert ext.values() == [3, 5, 7]
    dropped = ext.drop()
    assert dropped.values() == [3, 5]
    assert base.is_subbase_of(ext)


def test_rnsbase_array_ops():
    base = RNSBase([13, 17, 19])
    vals = [0, 1, 4000 % (13 * 17 * 19), 12 * 17]
    arr = base.decompose_array(vals)
    assert arr.shape == (3, len(vals))
    back = base.compose_array(arr)
    assert back == vals


# ---------------------------------------------------------------------------
# BaseConverter (reference: tests/seal/util/rns.cpp:277-382)
# ---------------------------------------------------------------------------

def _fastbconv_exact(x_residues, ibase_vals, obase_vals):
    """BEHZ approximate base conversion, exact integer model:
    out_j = sum_i ([x_i * (q/q_i)^{-1}]_{q_i} * (q/q_i)) mod p_j."""
    q = 1
    for v in ibase_vals:
        q *= v
    outs = []
    for pj in obase_vals:
        acc = 0
        for i, qi in enumerate(ibase_vals):
            punc = q // qi
            inv = pow(punc % qi, -1, qi)
            acc += ((x_residues[i] * inv) % qi) * (punc % pj)
        outs.append(acc % pj)
    return outs


def test_base_converter_matches_exact_model():
    ib = RNSBase([1009, 2003])
    ob = RNSBase([3001, 4001, 5003])
    conv = BaseConverter(ib, ob)
    dev = rnsops.DeviceBaseConverter.from_host(conv)

    n = 8
    x = np.stack([
        RNG.integers(0, 1009, size=n, dtype=np.uint64),
        RNG.integers(0, 2003, size=n, dtype=np.uint64),
    ])
    out = np.asarray(fast_convert_array(x, dev))
    for k in range(n):
        want = _fastbconv_exact(
            [int(x[0, k]), int(x[1, k])], [1009, 2003], [3001, 4001, 5003]
        )
        assert [int(out[j, k]) for j in range(3)] == want


def test_base_converter_60bit():
    ip = [int(p) for p in get_primes(1 << 8, 60, 2)]
    op = [int(p) for p in get_primes(1 << 8, 59, 3)]
    ib = RNSBase(ip)
    ob = RNSBase(op)
    dev = rnsops.DeviceBaseConverter.from_host(BaseConverter(ib, ob))
    n = 16
    x = np.stack([
        RNG.integers(0, p, size=n, dtype=np.uint64) for p in ip
    ])
    out = np.asarray(fast_convert_array(x, dev))
    for k in range(4):
        want = _fastbconv_exact(
            [int(x[i, k]) for i in range(2)], ip, op,
        )
        assert [int(out[j, k]) for j in range(3)] == want


# ---------------------------------------------------------------------------
# RNSTool primitives (reference: tests/seal/util/rns.cpp:383-994)
# ---------------------------------------------------------------------------

def make_tool(n=32, bits=(50, 50), t_val=65537):
    q = RNSBase(get_primes(2 * n, bits[0], len(bits)))
    t = Modulus(t_val)
    host = RNSTool(n, q, t)
    return host, DeviceRNSTool(host)


def test_fastbconv_m_tilde_and_sm_mrq():
    """q -> Bsk via m_tilde premultiply + Montgomery reduce must equal the
    exact conversion of the (small) input (rns.cpp FastBConvMTilde +
    MontgomeryReduction): sm_mrq eliminates the q-overflow term exactly for
    inputs that are exact in q."""
    host, tool = make_tool()
    n = host.coeff_count
    q_vals = [m.value for m in host.base_q.base]
    bsk_vals = [m.value for m in host.base_Bsk.base]

    # a small value, exactly representable: x < q
    x_int = [int(RNG.integers(0, min(q_vals))) for _ in range(n)]
    x = np.stack([np.array([v % p for v in x_int], dtype=np.uint64)
                  for p in q_vals])

    lifted = fastbconv_m_tilde(x, tool)
    out = np.asarray(sm_mrq(lifted, tool))
    for k in range(4):
        for j, pj in enumerate(bsk_vals):
            assert int(out[j, k]) == x_int[k] % pj


def test_fast_floor():
    """fast_floor(q*v + r) == v (+bounded error absorbed for r < q)
    (rns.cpp FastFloor)."""
    host, tool = make_tool()
    n = host.coeff_count
    q_vals = [m.value for m in host.base_q.base]
    bsk_vals = [m.value for m in host.base_Bsk.base]
    q = 1
    for v in q_vals:
        q *= v

    vals = [int(RNG.integers(0, 1 << 40)) for _ in range(n)]
    xs = [q * v for v in vals]  # exact multiples: floor is exact
    x_q = np.stack([np.array([x % p for x in xs], dtype=np.uint64)
                    for p in q_vals])
    x_bsk = np.stack([np.array([x % p for x in xs], dtype=np.uint64)
                      for p in bsk_vals])
    out = np.asarray(fast_floor(x_q, x_bsk, tool))
    for k in range(4):
        for j, pj in enumerate(bsk_vals):
            assert int(out[j, k]) == vals[k] % pj


def test_fastbconv_sk():
    """Shenoy-Kumaresan Bsk -> q is exact (not approximate) for values
    representable in B (rns.cpp FastBConvSK)."""
    host, tool = make_tool()
    n = host.coeff_count
    q_vals = [m.value for m in host.base_q.base]
    bsk_vals = [m.value for m in host.base_Bsk.base]

    vals = [int(RNG.integers(0, 1 << 50)) for _ in range(n)]
    x_bsk = np.stack([np.array([v % p for v in vals], dtype=np.uint64)
                      for p in bsk_vals])
    out = np.asarray(fastbconv_sk(x_bsk, tool))
    for k in range(4):
        for j, pj in enumerate(q_vals):
            assert int(out[j, k]) == vals[k] % pj


def test_decrypt_scale_and_round():
    """round(t/q * (m * Delta + small_noise)) == m (rns.cpp
    ExactScaleAndRound)."""
    host, tool = make_tool(bits=(50, 50), t_val=65537)
    n = host.coeff_count
    q_vals = [m.value for m in host.base_q.base]
    t = 65537
    q = 1
    for v in q_vals:
        q *= v
    delta = q // t

    msg = [int(RNG.integers(0, t)) for _ in range(n)]
    noise = [int(RNG.integers(0, 1 << 20)) - (1 << 19) for _ in range(n)]
    xs = [(m * delta + e) % q for m, e in zip(msg, noise)]
    x = np.stack([np.array([x % p for x in xs], dtype=np.uint64)
                  for p in q_vals])
    out = np.asarray(decrypt_scale_and_round(x, tool))
    for k in range(n):
        assert int(out[k]) == msg[k], k


def _exact_divide_round_last(xs, q_vals):
    """Reference semantics of divide_and_round_q_last_inplace: per remaining
    limb, (x - [x + qk/2 mod qk] + qk/2) * qk^{-1} mod qi — a rounded
    division by q_last with error <= 1/2 handled by the +qk/2 shift."""
    qk = q_vals[-1]
    half = qk >> 1
    outs = []
    for x in xs:
        shifted = x + half
        rem = shifted % qk
        outs.append((shifted - rem) // qk)
    return outs


def test_divide_and_round_q_last():
    host, tool = make_tool(bits=(50, 50, 50))
    n = host.coeff_count
    q_vals = [m.value for m in host.base_q.base]
    q = 1
    for v in q_vals:
        q *= v

    xs = [int(RNG.integers(0, 2 ** 63)) * int(RNG.integers(0, 2 ** 63)) % q
          for _ in range(n)]
    x = np.stack([np.array([x % p for x in xs], dtype=np.uint64)
                  for p in q_vals])
    out = np.asarray(divide_and_round_q_last(x, tool))
    want = _exact_divide_round_last(xs, q_vals)
    for k in range(4):
        for j, pj in enumerate(q_vals[:-1]):
            assert int(out[j, k]) == want[k] % pj


def test_divide_and_round_q_last_ntt_matches_power_basis():
    host, tool = make_tool(bits=(50, 50, 50))
    n = host.coeff_count
    q_vals = [m.value for m in host.base_q.base]
    log_n = n.bit_length() - 1
    tables = build_ntt_tables(log_n, host.base_q.base)

    x = np.stack([RNG.integers(0, p, size=n, dtype=np.uint64)
                  for p in q_vals])
    want = np.asarray(divide_and_round_q_last(x, tool))
    x_ntt = np.asarray(ntt_forward(x, tables))
    got_ntt = divide_and_round_q_last_ntt(x_ntt, tool, tables)
    from gemini_seal.ops.rnsops import _slice_tables
    got = np.asarray(ntt_inverse(got_ntt, _slice_tables(tables, 0, len(q_vals) - 1)))
    np.testing.assert_array_equal(got, want)


def test_divide_and_round_multi():
    """Fused multi-level drop == one rounded division by Q_D up to the
    bounded CRT-interpolation excess (< |D|), vs the exact integer model."""
    from gemini_seal.context import SealContext
    from gemini_seal.params import EncryptionParameters, SchemeType
    from gemini_seal.modulus import CoeffModulus, PlainModulus, SecLevelType
    from gemini_seal.ops.rnsops import MultiDropPlan, divide_and_round_multi

    parms = EncryptionParameters(SchemeType.BFV)
    n = 32
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [50, 40, 40, 40]))
    parms.set_plain_modulus(PlainModulus.batching(n, 14))
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    cd = ctx.first_context_data()
    q_vals = [m.value for m in cd.parms.coeff_modulus]
    q = 1
    for v in q_vals:
        q *= v
    levels = 2
    q_d = q_vals[-1] * q_vals[-2]

    plan = MultiDropPlan(ctx, cd.parms_id, levels)
    xs = [int(RNG.integers(0, 2 ** 62)) * int(RNG.integers(0, 2 ** 62)) % q
          for _ in range(n)]
    x = np.stack([np.array([v % p for v in xs], dtype=np.uint64)
                  for p in q_vals])
    out = np.asarray(divide_and_round_multi(x, plan))
    n_out = plan.n_out
    for k in range(8):
        want = (xs[k] + (q_d >> 1)) // q_d        # round-half-up
        got = [int(out[j, k]) for j in range(n_out)]
        # allow the bounded interpolation excess (0..|D|)
        ok = any(all((want + e) % p == g
                     for p, g in zip(q_vals[:n_out], got))
                 for e in range(-levels, levels + 1))
        assert ok, (k, got, want)


def test_multi_drop_decrypts_like_sequential():
    from gemini_seal import (BatchEncoder, Decryptor, Encryptor,
                                 Evaluator, KeyGenerator)
    from gemini_seal.context import SealContext
    from gemini_seal.params import EncryptionParameters, SchemeType
    from gemini_seal.modulus import CoeffModulus, PlainModulus, SecLevelType
    from gemini_seal.ops.rnsops import MultiDropPlan, divide_and_round_multi
    from gemini_seal.ciphertext import Ciphertext

    parms = EncryptionParameters(SchemeType.BFV)
    n = 64
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [50, 40, 40, 40]))
    parms.set_plain_modulus(PlainModulus.batching(n, 14))
    parms.set_random_seed(tuple(range(8)))
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    be = BatchEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    ev = Evaluator(ctx)

    ct = enc.encrypt(be.encode(list(range(n))))
    seq = ev.mod_switch_to(ct, ctx.last_parms_id)

    plan = MultiDropPlan(ctx, ct.parms_id, 2)
    fused_data = np.asarray(divide_and_round_multi(np.asarray(ct.data), plan))
    fused = Ciphertext(fused_data, ctx.last_parms_id, False, ct.scale)

    assert be.decode(dec.decrypt(fused)) == be.decode(dec.decrypt(seq))
