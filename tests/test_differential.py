"""Randomized differential testing: the host plane (exact numpy) and the
device plane (DeviceEvaluator / jitted ops) must agree bit-exactly over
random CKKS/BFV op sequences — a property check on the backend-dispatch
contract (no reference analogue; its only backend is eager C++)."""

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

SEED = tuple(range(51, 59))


def _assert_same(d, h):
    np.testing.assert_array_equal(np.asarray(d.data), np.asarray(h.data))
    assert d.parms_id == h.parms_id and d.is_ntt_form == h.is_ntt_form


def test_ckks_random_walk():
    parms = EncryptionParameters(SchemeType.CKKS)
    n = 128
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [40, 30, 30, 30, 40]))
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    ev = Evaluator(ctx)
    dev = DeviceEvaluator(ctx)
    rk = kg.relin_keys()
    gk = kg.galois_keys_from_steps([1, 2, -1])
    scale = 2.0 ** 30

    rng = np.random.default_rng(2024)
    h = enc.encrypt(encoder.encode([0.4, -0.7, 0.9], scale))
    d = dev.put(h)
    levels_left = 3

    for step in range(24):
        op = rng.integers(0, 5)
        if op == 0:      # self-add
            h = ev.add(h, h)
            d = dev.add(d, d)
        elif op == 1:    # negate
            h = ev.negate(h)
            d = dev.negate(d)
        elif op == 2 and levels_left > 0:   # square+relin+rescale
            h = ev.rescale_to_next(ev.relinearize(ev.multiply(h, h), rk))
            d = dev.rescale_to_next(dev.relinearize(dev.multiply(d, d), rk))
            levels_left -= 1
        elif op == 3:    # rotate
            s = int(rng.choice([1, 2, -1]))
            h = ev.rotate_vector(h, s, gk)
            d = dev.rotate_vector(d, s, gk)
        elif op == 4 and levels_left > 0:   # mod switch drop
            h = ev.mod_switch_to_next(h)
            d = dev.mod_switch_to_next(d)
            levels_left -= 1
        else:            # add_plain at the current level/scale
            pt = encoder.encode([0.25, -0.5], h.scale, h.parms_id)
            h = ev.add_plain(h, pt)
            d = dev.add_plain(d, pt)
        _assert_same(d, h)

    # final sanity: decrypt both and compare decoded values exactly
    got_h = encoder.decode(dec.decrypt(h))
    got_d = encoder.decode(dec.decrypt(dev.get(d)))
    np.testing.assert_allclose(got_h[:3], got_d[:3], rtol=0, atol=0)


def test_bfv_random_walk():
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
    gk = kg.galois_keys_from_steps([1, -1])

    rng = np.random.default_rng(77)
    h = enc.encrypt(be.encode(list(range(n))))
    d = dev.put(h)

    for step in range(16):
        op = rng.integers(0, 4)
        if op == 0:
            h = ev.negate(h)
            d = dev.negate(d)
        elif op == 1:
            h = ev.relinearize(ev.multiply(h, h), rk)
            d = dev.relinearize(dev.multiply(d, d), rk)
        elif op == 2:
            s = int(rng.choice([1, -1]))
            h = ev.rotate_rows(h, s, gk)
            d = dev.rotate_rows(d, s, gk)
        else:
            h = ev.add(h, h)
            d = dev.add(d, d)
        _assert_same(d, h)

    assert be.decode(dec.decrypt(h)) == be.decode(dec.decrypt(dev.get(d)))
