"""DeviceEvaluator (jit-cached SEAL-style API) is bit-exact vs the host
Evaluator for every op, with ciphertexts resident as device arrays."""

import numpy as np
import pytest

from gemini_seal import (
    BatchEncoder,
    CKKSEncoder,
    CoeffModulus,
    Decryptor,
    EncryptionParameters,
    Encryptor,
    Evaluator,
    KeyGenerator,
    PlainModulus,
    SchemeType,
    SecLevelType,
    SealContext,
)
from gemini_seal.models.device_evaluator import DeviceEvaluator

SEED = tuple(range(31, 39))


@pytest.fixture(scope="module")
def ckks():
    parms = EncryptionParameters(SchemeType.CKKS)
    n = 256
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [40, 30, 30, 40]))
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    return ctx, kg, enc, encoder


def _eq(dev_ct, host_ct):
    np.testing.assert_array_equal(np.asarray(dev_ct.data), np.asarray(host_ct.data))
    assert dev_ct.parms_id == host_ct.parms_id
    assert dev_ct.is_ntt_form == host_ct.is_ntt_form
    assert abs(dev_ct.scale - host_ct.scale) < 1e-6 * host_ct.scale


def test_ckks_ops_match_host(ckks):
    ctx, kg, enc, encoder = ckks
    ev = Evaluator(ctx)
    dev = DeviceEvaluator(ctx)
    rk = kg.relin_keys()
    tool = ctx.first_context_data().galois_tool
    n = ctx.first_context_data().parms.poly_modulus_degree
    gk = kg.galois_keys([tool.get_elt_from_step(1), tool.get_elt_from_step(2), 2 * n - 1])
    scale = 2.0 ** 30

    a = enc.encrypt(encoder.encode([0.5, -1.0, 2.0], scale))
    b = enc.encrypt(encoder.encode([1.5, 0.25, -0.5], scale))
    da, db = dev.put(a), dev.put(b)

    _eq(dev.add(da, db), ev.add(a, b))
    _eq(dev.sub(da, db), ev.sub(a, b))
    _eq(dev.negate(da), ev.negate(a))

    prod_h = ev.multiply(a, b)
    prod_d = dev.multiply(da, db)
    _eq(prod_d, prod_h)

    rel_h = ev.relinearize(prod_h, rk)
    rel_d = dev.relinearize(prod_d, rk)
    _eq(rel_d, rel_h)

    res_h = ev.rescale_to_next(rel_h)
    res_d = dev.rescale_to_next(rel_d)
    _eq(res_d, res_h)

    _eq(dev.rotate_vector(da, 1, gk), ev.rotate_vector(a, 1, gk))
    _eq(dev.complex_conjugate(da, gk), ev.complex_conjugate(a, gk))
    _eq(dev.mod_switch_to_next(da), ev.mod_switch_to_next(a))

    pt = encoder.encode([2.0, 2.0, 2.0], scale, a.parms_id)
    _eq(dev.multiply_plain(da, pt), ev.multiply_plain(a, pt))
    _eq(dev.add_plain(da, pt), ev.add_plain(a, pt))

    # hoisted multi-rotation matches the host hoisted API
    host_many = ev.rotate_vector_many(a, [1, 2], gk)
    dev_many = dev.rotate_vector_many(da, [1, 2], gk)
    for h, d in zip(host_many, dev_many):
        _eq(d, h)

    # second calls hit the jit cache (same executables)
    n_compiled = len(dev._jit_cache)
    dev.add(da, db)
    dev.multiply(da, db)
    assert len(dev._jit_cache) == n_compiled


def test_bfv_ops_match_host():
    n = 64
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [40, 40, 40]))
    parms.set_plain_modulus(PlainModulus.batching(n, 20))
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    be = BatchEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    ev = Evaluator(ctx)
    dev = DeviceEvaluator(ctx)
    rk = kg.relin_keys()
    gk = kg.galois_keys_from_steps([1])

    a = enc.encrypt(be.encode(list(range(n))))
    b = enc.encrypt(be.encode([2] * n))
    da, db = dev.put(a), dev.put(b)

    _eq(dev.add(da, db), ev.add(a, b))
    prod_h = ev.multiply(a, b)
    prod_d = dev.multiply(da, db)
    _eq(prod_d, prod_h)
    rel_d = dev.relinearize(prod_d, rk)
    _eq(rel_d, ev.relinearize(prod_h, rk))
    _eq(dev.rotate_rows(da, 1, gk), ev.rotate_rows(a, 1, gk))
    _eq(dev.mod_switch_to_next(da), ev.mod_switch_to_next(a))

    # end to end: decrypt the device-computed result
    out = be.decode(dec.decrypt(dev.get(rel_d)))
    assert out[:n] == [2 * i for i in range(n)]


def test_multiply_relin_rescale_one_call(ckks):
    ctx, kg, enc, encoder = ckks
    ev = Evaluator(ctx)
    dev = DeviceEvaluator(ctx)
    rk = kg.relin_keys()
    scale = 2.0 ** 30
    a = enc.encrypt(encoder.encode([0.5, -1.0, 2.0], scale))
    da = dev.put(a)
    dec = Decryptor(ctx, kg.secret_key)

    host = ev.rescale_to_next(ev.relinearize(ev.multiply(a, a), rk))
    for fused in (False, True):
        out = dev.multiply_relin_rescale(da, da, rk, fused=fused)
        assert out.parms_id == host.parms_id
        got = encoder.decode(dec.decrypt(dev.get(out)))
        want = encoder.decode(dec.decrypt(host))
        for g, w in zip(got[:3], want[:3]):
            assert abs(g - w) < 1e-5, (fused, g, w)


def test_device_surface_parity_extended(ckks):
    """The round-2 surface closure: sub_plain,
    transform_to/from_ntt, mod_switch_to/rescale_to(parms_id), add_many —
    each bit-exact vs the host Evaluator."""
    ctx, kg, enc, encoder = ckks
    ev = Evaluator(ctx)
    dev = DeviceEvaluator(ctx)
    scale = 2.0 ** 30

    a = enc.encrypt(encoder.encode([0.5, -1.0, 2.0], scale))
    b = enc.encrypt(encoder.encode([0.25, 0.75, -2.0], scale))
    c = enc.encrypt(encoder.encode([1.0, 1.0, 1.0], scale))
    da, db, dc = dev.put(a), dev.put(b), dev.put(c)

    pt = encoder.encode([2.0, 2.0, 2.0], scale, a.parms_id)
    _eq(dev.sub_plain(da, pt), ev.sub_plain(a, pt))
    _eq(dev.add_many([da, db, dc]), ev.add_many([a, b, c]))

    last = ctx.last_parms_id
    _eq(dev.mod_switch_to(da, last), ev.mod_switch_to(a, last))
    rk = kg.relin_keys()
    prod_h = ev.relinearize(ev.multiply(a, b), rk)
    prod_d = dev.relinearize(dev.multiply(da, db), rk)
    _eq(dev.rescale_to(prod_d, last), ev.rescale_to(prod_h, last))

    # NTT round trip (CKKS fresh cts are NTT-form)
    pw = dev.transform_from_ntt(da)
    _eq(pw, ev.transform_from_ntt(a))
    _eq(dev.transform_to_ntt(pw), ev.transform_to_ntt(ev.transform_from_ntt(a)))


def test_device_bfv_composites_match_host():
    n = 64
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [40, 40, 40, 40]))
    parms.set_plain_modulus(PlainModulus.batching(n, 20))
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    be = BatchEncoder(ctx)
    ev = Evaluator(ctx)
    dev = DeviceEvaluator(ctx)
    rk = kg.relin_keys()
    gk = kg.galois_keys()

    a = enc.encrypt(be.encode([2] * n))
    b = enc.encrypt(be.encode([3] * n))
    cc = enc.encrypt(be.encode([1] * n))
    da, db, dc = dev.put(a), dev.put(b), dev.put(cc)

    _eq(dev.multiply_many([da, db, dc], rk), ev.multiply_many([a, b, cc], rk))
    _eq(dev.exponentiate(da, 3, rk), ev.exponentiate(a, 3, rk))
    _eq(dev.rotate_columns(da, gk), ev.rotate_columns(a, gk))
    host_many = ev.rotate_rows_many(a, [1, 2], gk)
    dev_many = dev.rotate_rows_many(da, [1, 2], gk)
    for h, d in zip(host_many, dev_many):
        _eq(d, h)


def test_square_relin_rescale_one_call(ckks):
    ctx, kg, enc, encoder = ckks
    dev = DeviceEvaluator(ctx)
    rk = kg.relin_keys()
    a = enc.encrypt(encoder.encode([0.5, -1.0, 2.0], 2.0 ** 30))
    da = dev.put(a)
    for fused in (False, True):
        sq = dev.square_relin_rescale(da, rk, fused=fused)
        mu = dev.multiply_relin_rescale(da, da, rk, fused=fused)
        _eq(sq, mu)  # bit-exact with multiply(a, a) under the same mode


def test_device_plain_op_validation(ckks):
    """Device plain-op fast paths run the host's metadata validations
    (code-review r2 findings #2/#3)."""
    ctx, kg, enc, encoder = ckks
    dev = DeviceEvaluator(ctx)
    scale = 2.0 ** 30
    a = dev.put(enc.encrypt(encoder.encode([0.5], scale)))

    # plain at a lower level: parameter mismatch must raise
    low = ctx.first_context_data().next_context_data.parms_id
    pt_low = encoder.encode([2.0], scale, low)
    for op in (dev.add_plain, dev.sub_plain, dev.multiply_plain):
        with pytest.raises(ValueError, match="parameter mismatch"):
            op(a, pt_low)

    # mismatched scale must raise on add/sub
    pt_scale = encoder.encode([2.0], scale * 2, a.parms_id)
    for op in (dev.add_plain, dev.sub_plain):
        with pytest.raises(ValueError, match="scale mismatch"):
            op(a, pt_scale)

    # CKKS square of power-basis data must raise like the host
    pw = dev.transform_from_ntt(a)
    with pytest.raises(ValueError, match="NTT form"):
        dev.square(pw)


def test_device_rotate_naf_fallback(ckks):
    """DeviceEvaluator mirrors the host rotation guards: NAF fallback for
    composite steps, clean error for a power-of-two step with a missing
    key (host parity, evaluator.cpp:1945-1999)."""
    from gemini_seal import Decryptor

    ctx, kg, enc, encoder = ckks
    dev = DeviceEvaluator(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    tool = ctx.first_context_data().galois_tool
    scale = 2.0 ** 30
    gk1 = kg.galois_keys(tool.get_elts_from_steps([1]))
    gk = kg.galois_keys(tool.get_elts_from_steps([4, -1]))
    vals = [float(i) for i in range(encoder.slot_count)]
    ct = dev.put(enc.encrypt(encoder.encode(vals, scale)))
    with pytest.raises(ValueError, match="Galois key not present"):
        dev.rotate_vector(ct, 4, gk1)
    rot = dev.rotate_vector(ct, 3, gk)  # NAF(3) = [4, -1]
    got = encoder.decode(dec.decrypt(dev.get(rot)))
    assert abs(got[0] - 3.0) < 1e-2 and abs(got[1] - 4.0) < 1e-2
