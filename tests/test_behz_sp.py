"""Explicit limb-sharded BFV BEHZ multiply+relinearize: bit-exact vs the
in-core build_bfv_mul_relin, with the planned five-gather comm profile
(two extends, fast_floor, fastbconv_sk, relin target) and no reduction
or permute collectives."""

import numpy as np
import pytest

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from gemini_seal import (
    BatchEncoder,
    CoeffModulus,
    Decryptor,
    EncryptionParameters,
    Encryptor,
    KeyGenerator,
    PlainModulus,
    SchemeType,
    SecLevelType,
    SealContext,
)
from gemini_seal.ciphertext import Ciphertext
from gemini_seal.models.pipelines import build_bfv_mul_relin
from gemini_seal.parallel.behz_sp import bfv_mul_relin_limb_sharded
from gemini_seal.parallel.comm import collective_stats

SEED = tuple(range(71, 79))

needs4 = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 devices")
needs8 = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")


def setup(n, bits, t=257):
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, list(bits)))
    parms.set_plain_modulus(t)
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    return ctx, KeyGenerator(ctx)


def _mesh(*shape_names):
    from jax.sharding import Mesh

    shape = tuple(s for s, _ in shape_names)
    names = tuple(n for _, n in shape_names)
    total = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:total]).reshape(shape), names)


def _case(ctx, kg, batch=None):
    from gemini_seal import Plaintext

    enc = Encryptor(ctx, public_key=kg.public_key())
    rk = kg.relin_keys()
    a = np.asarray(enc.encrypt(Plaintext.from_hex("3x^2 + 2")).data)
    b = np.asarray(enc.encrypt(Plaintext.from_hex("5x^1 + 7")).data)
    if batch:
        a = np.stack([np.roll(a, i, axis=-1) for i in range(batch)])
        b = np.broadcast_to(b, (batch,) + b.shape).copy()
    kdata = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
    want = np.asarray(jax.jit(build_bfv_mul_relin(ctx))(a, b, kdata))
    return a, b, kdata, want


@needs4
def test_bit_exact_small():
    ctx, kg = setup(64, [30] * 5)
    a, b, kdata, want = _case(ctx, kg)
    mesh = _mesh((4, "limb"))
    sh = NamedSharding(mesh, P(None, "limb", None))
    out = np.asarray(bfv_mul_relin_limb_sharded(
        jax.device_put(a, sh), jax.device_put(b, sh), kdata, ctx, mesh
    ))
    np.testing.assert_array_equal(out, want)


@needs4
def test_bit_exact_realistic_batched():
    """N=2048, L=8, batch 2."""
    ctx, kg = setup(2048, [30] * 9, t=PlainModulus.batching(2048, 20).value)
    a, b, kdata, want = _case(ctx, kg, batch=2)
    mesh = _mesh((4, "limb"))
    sh = NamedSharding(mesh, P(None, None, "limb", None))
    out = np.asarray(bfv_mul_relin_limb_sharded(
        jax.device_put(a, sh), jax.device_put(b, sh), kdata, ctx, mesh
    ))
    np.testing.assert_array_equal(out, want)


@needs8
def test_dp_limb_bit_exact():
    ctx, kg = setup(64, [30] * 5)
    a, b, kdata, want = _case(ctx, kg, batch=4)
    mesh = _mesh((2, "dp"), (4, "limb"))
    sh = NamedSharding(mesh, P("dp", None, "limb", None))
    out = np.asarray(bfv_mul_relin_limb_sharded(
        jax.device_put(a, sh), jax.device_put(b, sh), kdata, ctx, mesh
    ))
    np.testing.assert_array_equal(out, want)


@needs4
def test_five_gather_comm_profile():
    """Exactly five all-gathers (2 extends + floor + sk + relin target),
    no all-reduce / reduce-scatter / all-to-all / collective-permute."""
    ctx, kg = setup(64, [30] * 5)
    a, b, kdata, want = _case(ctx, kg)
    mesh = _mesh((4, "limb"))
    sh = NamedSharding(mesh, P(None, "limb", None))
    da, db = jax.device_put(a, sh), jax.device_put(b, sh)
    bfv_mul_relin_limb_sharded(da, db, kdata, ctx, mesh)  # warm cache

    fn = jax.jit(
        lambda x, y: bfv_mul_relin_limb_sharded(x, y, kdata, ctx, mesh),
        in_shardings=(sh, sh),
    )
    stats = collective_stats(fn.lower(da, db).compile().as_text())
    assert stats.count.get("all-gather", 0) == 5, stats
    assert "all-reduce" not in stats.count, stats
    assert "reduce-scatter" not in stats.count, stats
    assert "all-to-all" not in stats.count, stats
    assert "collective-permute" not in stats.count, stats
