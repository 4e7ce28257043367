"""Coefficient-sharded end-to-end pipeline (NTT-SP composed): bit-exact
vs the in-core switch_key / mul+relin+rescale, with an all_to_all-only
collective profile (two transposes per NTT, nothing else)."""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gemini_seal import (
    CKKSEncoder,
    CoeffModulus,
    EncryptionParameters,
    Encryptor,
    KeyGenerator,
    SchemeType,
    SecLevelType,
    SealContext,
)
from gemini_seal.models.pipelines import build_ckks_mul_relin_rescale
from gemini_seal.ops.keyswitch import KeySwitchPlan, switch_key
from gemini_seal.parallel.comm import collective_stats
from gemini_seal.parallel.pipeline_csp import (
    ckks_mul_relin_rescale_coeff_sharded,
    switch_key_coeff_sharded,
)

SEED = tuple(range(51, 59))

needs4 = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 devices")
needs8 = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")


def setup(n, bits, nsp=1):
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, list(bits)))
    parms.set_n_special_primes(nsp)
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    return ctx, KeyGenerator(ctx)


def _mesh_coeff(c):
    return Mesh(np.asarray(jax.devices()[:c]), axis_names=("coeff",))


@needs4
def test_switch_key_coeff_sharded_bit_exact():
    """N=4096, L=8, nsp=2 — realistic deep shape, C=4 over coefficients."""
    ctx, kg = setup(4096, [30] * 10, nsp=2)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    rk = kg.relin_keys()
    plan = KeySwitchPlan(ctx, ctx.first_parms_id)

    ct = enc.encrypt(encoder.encode([0.5, -1.25, 2.0], 2.0 ** 25))
    target = np.asarray(ct.data)[1]
    kdata = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
    want0, want1 = switch_key(target, kdata, plan, True)

    mesh = _mesh_coeff(4)
    sh = NamedSharding(mesh, P(None, "coeff"))
    ksh = NamedSharding(mesh, P(None, None, None, "coeff"))
    d0, d1 = switch_key_coeff_sharded(
        jax.device_put(target, sh), jax.device_put(kdata, ksh), plan, mesh
    )
    np.testing.assert_array_equal(np.asarray(d0), np.asarray(want0))
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(want1))


@needs4
def test_full_pipeline_coeff_sharded_bit_exact_and_profile():
    """mul+relin+rescale with the coefficient axis sharded: bit-exact vs
    the in-core step; collectives are all_to_all ONLY (2 per NTT call:
    modup inverse+forward, per-component rescale_special inverse+forward,
    final q_last inverse+forward)."""
    ctx, kg = setup(4096, [30] * 8, nsp=1)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    rk = kg.relin_keys()
    plan = KeySwitchPlan(ctx, ctx.first_parms_id)

    a = np.asarray(enc.encrypt(encoder.encode([0.5, -1.0], 2.0 ** 25)).data)
    b = np.asarray(enc.encrypt(encoder.encode([1.5, 0.25], 2.0 ** 25)).data)
    kdata = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
    want = np.asarray(jax.jit(build_ckks_mul_relin_rescale(ctx))(a, b, kdata))

    mesh = _mesh_coeff(4)
    sh = NamedSharding(mesh, P(None, None, "coeff"))
    ksh = NamedSharding(mesh, P(None, None, None, "coeff"))
    da, db = jax.device_put(a, sh), jax.device_put(b, sh)
    dk = jax.device_put(kdata, ksh)
    out = np.asarray(
        ckks_mul_relin_rescale_coeff_sharded(da, db, dk, plan, mesh)
    )
    np.testing.assert_array_equal(out, want)

    fn = jax.jit(
        lambda x, y, k: ckks_mul_relin_rescale_coeff_sharded(x, y, k, plan, mesh),
        in_shardings=(sh, sh, ksh),
    )
    stats = collective_stats(fn.lower(da, db, dk).compile().as_text())
    assert "all-gather" not in stats.count, stats
    assert "all-reduce" not in stats.count, stats
    assert "collective-permute" not in stats.count, stats
    assert stats.count.get("all-to-all", 0) > 0, stats
    # NTT calls in the step: modup (inv_lazy + fwd_lazy), 2x rescale_special
    # (inv_lazy + fwd), final rescale (inv + fwd) = 8 transforms -> 16
    # transposes (XLA may fuse adjacent same-shape transposes; bound it)
    assert stats.count["all-to-all"] <= 16, stats


@needs4
def test_switch_key_coeff_sharded_batched():
    ctx, kg = setup(1024, [30] * 6, nsp=1)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    rk = kg.relin_keys()
    plan = KeySwitchPlan(ctx, ctx.first_parms_id)

    ct = enc.encrypt(encoder.encode([1.0, 2.0], 2.0 ** 25))
    base = np.asarray(ct.data)[1]
    target = np.stack([base, np.roll(base, 3, axis=-1)])
    kdata = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
    want0, want1 = switch_key(target, kdata, plan, True)

    mesh = _mesh_coeff(4)
    sh = NamedSharding(mesh, P(None, None, "coeff"))
    ksh = NamedSharding(mesh, P(None, None, None, "coeff"))
    d0, d1 = switch_key_coeff_sharded(
        jax.device_put(target, sh), jax.device_put(kdata, ksh), plan, mesh
    )
    np.testing.assert_array_equal(np.asarray(d0), np.asarray(want0))
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(want1))


@needs4
def test_rotate_coeff_sharded_bit_exact_and_profile():
    """One rotation under coefficient sharding: the Galois automorphism
    is block-local (one collective-permute + local gather — see
    _galois_block_plan), so the profile is the switch's all_to_alls plus
    AT MOST one collective-permute, and rows are bit-exact vs
    Evaluator.apply_galois."""
    from gemini_seal import Evaluator
    from gemini_seal.parallel.pipeline_csp import (
        ckks_rotate_coeff_sharded,
    )

    ctx, kg = setup(1024, [30] * 6, nsp=1)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    tool = ctx.first_context_data().galois_tool
    ev = Evaluator(ctx)
    elt = tool.get_elt_from_step(2)
    gk = kg.galois_keys([elt])
    plan = KeySwitchPlan(ctx, ctx.first_parms_id)

    ct = enc.encrypt(encoder.encode([0.5, -1.25, 2.0], 2.0 ** 25))
    want = np.asarray(ev.apply_galois(ct, elt, gk).data)
    kdata = gk.stacked(elt)

    mesh = _mesh_coeff(4)
    sh = NamedSharding(mesh, P(None, None, "coeff"))
    ksh = NamedSharding(mesh, P(None, None, None, "coeff"))
    data = jax.device_put(np.asarray(ct.data), sh)
    dk = jax.device_put(kdata, ksh)
    out = np.asarray(
        ckks_rotate_coeff_sharded(data, dk, elt, tool, plan, mesh)
    )
    np.testing.assert_array_equal(out, want)

    fn = jax.jit(
        lambda x, k: ckks_rotate_coeff_sharded(x, k, elt, tool, plan, mesh),
        in_shardings=(sh, ksh),
    )
    stats = collective_stats(fn.lower(data, dk).compile().as_text())
    assert "all-gather" not in stats.count, stats
    assert "all-reduce" not in stats.count, stats
    assert stats.count.get("collective-permute", 0) <= 1, stats
    assert stats.count.get("all-to-all", 0) > 0, stats


@needs4
def test_rotate_many_coeff_sharded_hoisted_bit_exact():
    """Hoisted k-rotation bundle under coefficient sharding, bit-exact vs
    Evaluator.apply_galois_many."""
    from gemini_seal import Ciphertext, Evaluator
    from gemini_seal.parallel.pipeline_csp import (
        ckks_rotate_many_coeff_sharded,
    )

    ctx, kg = setup(1024, [30] * 6, nsp=1)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    tool = ctx.first_context_data().galois_tool
    ev = Evaluator(ctx)
    steps = [1, -1, 4]
    elts = tool.get_elts_from_steps(steps)
    gk = kg.galois_keys(elts)
    plan = KeySwitchPlan(ctx, ctx.first_parms_id)

    ct = enc.encrypt(encoder.encode([0.5, -1.25, 2.0, 3.5], 2.0 ** 25))
    want = ev.apply_galois_many(ct, elts, gk)
    keys_stack = gk.stacked(*elts)

    mesh = _mesh_coeff(4)
    sh = NamedSharding(mesh, P(None, None, "coeff"))
    ksh = NamedSharding(mesh, P(None, None, None, None, "coeff"))
    data = jax.device_put(np.asarray(ct.data), sh)
    dk = jax.device_put(keys_stack, ksh)
    out = np.asarray(
        ckks_rotate_many_coeff_sharded(data, dk, elts, tool, plan, mesh)
    )
    for i in range(len(elts)):
        np.testing.assert_array_equal(out[i], np.asarray(want[i].data))


@needs8
def test_dp_coeff_mixed_mesh():
    """(dp=2, coeff=4): batch axis data-parallel, coefficients sharded —
    bit-exact for both the switch and the full step."""
    ctx, kg = setup(1024, [30] * 6, nsp=1)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    rk = kg.relin_keys()
    plan = KeySwitchPlan(ctx, ctx.first_parms_id)

    a = np.stack([
        np.asarray(enc.encrypt(encoder.encode([0.5 * (i + 1)], 2.0 ** 25)).data)
        for i in range(4)
    ])
    kdata = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
    want = np.asarray(jax.jit(build_ckks_mul_relin_rescale(ctx))(a, a, kdata))

    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("dp", "coeff"))
    sh = NamedSharding(mesh, P("dp", None, None, "coeff"))
    ksh = NamedSharding(mesh, P(None, None, None, "coeff"))
    da = jax.device_put(a, sh)
    dk = jax.device_put(kdata, ksh)
    out = np.asarray(
        ckks_mul_relin_rescale_coeff_sharded(da, da, dk, plan, mesh)
    )
    np.testing.assert_array_equal(out, want)

    tgt = a[:, 1]  # [4, n_ct, N] batched switch target
    want0, want1 = switch_key(tgt, kdata, plan, True)
    tsh = NamedSharding(mesh, P("dp", None, "coeff"))
    d0, d1 = switch_key_coeff_sharded(
        jax.device_put(tgt, tsh), dk, plan, mesh
    )
    np.testing.assert_array_equal(np.asarray(d0), np.asarray(want0))
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(want1))
