"""Explicit shard_map limb-sharded key switch: bit-exact vs the in-core
switch_key, with a communication-minimal profile — exactly ONE all_gather
of the power-basis target, no all-reduce / collective-permute (vs the
GSPMD profile in PERF.md's comm table)."""

import numpy as np
import pytest

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from gemini_seal import (
    CKKSEncoder,
    CoeffModulus,
    Decryptor,
    EncryptionParameters,
    Encryptor,
    Evaluator,
    KeyGenerator,
    SchemeType,
    SecLevelType,
    SealContext,
)
from gemini_seal.ops.keyswitch import KeySwitchPlan, switch_key
from gemini_seal.parallel.comm import collective_stats
from gemini_seal.parallel.keyswitch_sp import switch_key_limb_sharded

SEED = tuple(range(91, 99))

needs4 = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 devices")


def setup(n, bits, nsp=1):
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, list(bits)))
    parms.set_n_special_primes(nsp)
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    return ctx, KeyGenerator(ctx)


def _mesh_limb(c):
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:c]), axis_names=("limb",))


def _run_case(n, bits, nsp, C, batch=None):
    ctx, kg = setup(n, bits, nsp=nsp)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    rk = kg.relin_keys()
    plan = KeySwitchPlan(ctx, ctx.first_parms_id)
    assert plan.n_ct_rns % C == 0

    ct = enc.encrypt(encoder.encode([0.5, -1.25, 2.0], 2.0 ** 25))
    target = np.asarray(ct.data)[1]           # c1, [n_ct, N] NTT form
    if batch:
        target = np.broadcast_to(target, (batch,) + target.shape).copy()
    kdata = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])

    want0, want1 = switch_key(target, kdata, plan, True)

    mesh = _mesh_limb(C)
    nd = target.ndim
    spec = P(*([None] * (nd - 2) + ["limb", None]))
    sh = NamedSharding(mesh, spec)
    d0, d1 = switch_key_limb_sharded(
        jax.device_put(target, sh), kdata, plan, mesh
    )
    np.testing.assert_array_equal(np.asarray(d0), np.asarray(want0))
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(want1))
    return plan, mesh, sh, target, kdata


@needs4
def test_bit_exact_small():
    _run_case(n=64, bits=[30] * 5, nsp=1, C=4)


@needs4
def test_bit_exact_realistic_nsp2_batched():
    """N=4096, L=8 + nsp=2, batch 3 — realistic serving shape."""
    _run_case(n=4096, bits=[30] * 10, nsp=2, C=4, batch=3)


@needs4
def test_single_gather_comm_profile():
    """The compiled program must contain exactly the one planned
    all-gather (the power-basis target) and NO reduction/permute
    collectives — the hand-scheduled profile, vs GSPMD's
    all-gather + all-reduce + collective-permute mix."""
    plan, mesh, sh, target, kdata = _run_case(n=64, bits=[30] * 5, nsp=1, C=4)

    fn = jax.jit(
        lambda t: switch_key_limb_sharded(t, kdata, plan, mesh),
        in_shardings=(sh,),
    )
    txt = fn.lower(jax.device_put(target, sh)).compile().as_text()
    stats = collective_stats(txt)
    assert stats.count.get("all-gather", 0) == 1, stats
    assert "all-reduce" not in stats.count, stats
    assert "reduce-scatter" not in stats.count, stats
    assert "all-to-all" not in stats.count, stats
    assert "collective-permute" not in stats.count, stats
    # gather volume == the power-basis target, nothing more
    assert stats.bytes["all-gather"] <= target.nbytes, stats


@needs4
def test_bit_exact_bfv_power_basis():
    """BFV (power-basis) dataflow: same single-gather schedule, bit-exact
    vs the in-core switch_key(is_ntt_form=False)."""
    from gemini_seal import PlainModulus, Plaintext

    parms = EncryptionParameters(SchemeType.BFV)
    n = 64
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [30] * 5))
    parms.set_plain_modulus(257)
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    rk = kg.relin_keys()
    plan = KeySwitchPlan(ctx, ctx.first_parms_id)

    ct = enc.encrypt(Plaintext.from_hex("3x^2 + 2"))
    target = np.asarray(ct.data)[1]
    kdata = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
    want0, want1 = switch_key(target, kdata, plan, False)

    mesh = _mesh_limb(4)
    sh = NamedSharding(mesh, P("limb", None))
    d0, d1 = switch_key_limb_sharded(
        jax.device_put(target, sh), kdata, plan, mesh, is_ntt_form=False
    )
    np.testing.assert_array_equal(np.asarray(d0), np.asarray(want0))
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(want1))


@needs4
def test_full_pipeline_limb_sharded_bit_exact():
    """The composed mul+relin+rescale on the explicit schedule: rows
    [:n_ct-1] bit-exact vs pipelines.build_ckks_mul_relin_rescale; the
    dropped q_last row comes back zeroed; comm = 1 all-gather + 1
    tiny one-row all-reduce broadcast."""
    from gemini_seal.models.pipelines import build_ckks_mul_relin_rescale
    from gemini_seal.parallel.keyswitch_sp import (
        ckks_mul_relin_rescale_limb_sharded,
    )

    ctx, kg = setup(64, [30] * 5, nsp=1)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    rk = kg.relin_keys()
    plan = KeySwitchPlan(ctx, ctx.first_parms_id)
    n_ct = plan.n_ct_rns

    a = np.asarray(enc.encrypt(encoder.encode([0.5, -1.0], 2.0 ** 25)).data)
    b = np.asarray(enc.encrypt(encoder.encode([1.5, 0.25], 2.0 ** 25)).data)
    kdata = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])

    want = np.asarray(
        jax.jit(build_ckks_mul_relin_rescale(ctx))(a, b, kdata)
    )  # [2, n_ct-1, N]

    mesh = _mesh_limb(4)
    sh = NamedSharding(mesh, P(None, "limb", None))
    da, db = jax.device_put(a, sh), jax.device_put(b, sh)
    out = np.asarray(
        ckks_mul_relin_rescale_limb_sharded(da, db, kdata, plan, mesh)
    )
    np.testing.assert_array_equal(out[:, : n_ct - 1, :], want)
    assert np.all(out[:, n_ct - 1, :] == 0)

    # comm profile: exactly one all-gather + one tiny all-reduce
    fn = jax.jit(
        lambda x, y: ckks_mul_relin_rescale_limb_sharded(x, y, kdata, plan, mesh),
        in_shardings=(sh, sh),
    )
    stats = collective_stats(fn.lower(da, db).compile().as_text())
    assert stats.count.get("all-gather", 0) == 1, stats
    assert stats.count.get("all-reduce", 0) == 1, stats
    assert "collective-permute" not in stats.count, stats
    assert "all-to-all" not in stats.count, stats
    # the q_last broadcast all-reduce is one row per component - tiny vs the gather
    assert stats.bytes["all-reduce"] <= stats.bytes["all-gather"], stats


@needs4
def test_full_pipeline_realistic_shape():
    """Explicit full pipeline at the realistic serving shape
    (N=4096, L=8, nsp=2, batch 2), rows bit-exact vs the in-core step."""
    from gemini_seal.models.pipelines import build_ckks_mul_relin_rescale
    from gemini_seal.parallel.keyswitch_sp import (
        ckks_mul_relin_rescale_limb_sharded,
    )

    ctx, kg = setup(4096, [30] * 10, nsp=2)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    rk = kg.relin_keys()
    plan = KeySwitchPlan(ctx, ctx.first_parms_id)
    n_ct = plan.n_ct_rns

    a = np.stack([
        np.asarray(enc.encrypt(encoder.encode([0.5 * (i + 1)], 2.0 ** 25)).data)
        for i in range(2)
    ])
    kdata = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
    want = np.asarray(jax.jit(build_ckks_mul_relin_rescale(ctx))(a, a, kdata))

    mesh = _mesh_limb(4)
    sh = NamedSharding(mesh, P(None, None, "limb", None))
    da = jax.device_put(a, sh)
    out = np.asarray(
        ckks_mul_relin_rescale_limb_sharded(da, da, kdata, plan, mesh)
    )
    np.testing.assert_array_equal(out[..., : n_ct - 1, :], want)
    assert np.all(out[..., n_ct - 1, :] == 0)


@needs4
def test_rotate_many_hoisted_bit_exact_and_profile():
    """Hoisted k-rotation bundle on the explicit schedule: bit-exact vs
    Evaluator.apply_galois_many, and the compiled program contains exactly
    ONE all-gather for ALL k rotations (the hoisted mod-up digits are
    shared; per-step Galois permutations act on the unsharded N axis)."""
    from gemini_seal.parallel.keyswitch_sp import rotate_many_limb_sharded

    ctx, kg = setup(64, [30] * 5, nsp=1)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    tool = ctx.first_context_data().galois_tool
    steps = [1, 2, -1]
    elts = tool.get_elts_from_steps(steps)
    gk = kg.galois_keys(elts)
    ev = Evaluator(ctx)
    plan = KeySwitchPlan(ctx, ctx.first_parms_id)

    ct = enc.encrypt(encoder.encode([0.5, -1.25, 2.0, 0.125], 2.0 ** 25))
    want = ev.apply_galois_many(ct, elts, gk)

    keys_stack = gk.stacked(*elts)
    mesh = _mesh_limb(4)
    sh = NamedSharding(mesh, P(None, "limb", None))
    data = jax.device_put(np.asarray(ct.data), sh)
    out = np.asarray(
        rotate_many_limb_sharded(data, keys_stack, elts, tool, plan, mesh)
    )  # [k, 2, n_ct, N]
    for i in range(len(elts)):
        np.testing.assert_array_equal(out[i], np.asarray(want[i].data))

    fn = jax.jit(
        lambda t: rotate_many_limb_sharded(t, keys_stack, elts, tool, plan,
                                           mesh),
        in_shardings=(sh,),
    )
    stats = collective_stats(fn.lower(data).compile().as_text())
    assert stats.count.get("all-gather", 0) == 1, stats
    assert "all-reduce" not in stats.count, stats
    assert "collective-permute" not in stats.count, stats
    assert "all-to-all" not in stats.count, stats
    # gather volume == ONE power-basis target for the whole bundle
    assert stats.bytes["all-gather"] <= np.asarray(ct.data)[1].nbytes, stats


@needs4
def test_rotate_many_hoisted_bfv_power_basis():
    """BFV hoisted rotation bundle (power-basis c0 permutation with sign
    fold) on the explicit schedule, bit-exact vs apply_galois_many."""
    from gemini_seal import PlainModulus, Plaintext
    from gemini_seal.parallel.keyswitch_sp import rotate_many_limb_sharded

    parms = EncryptionParameters(SchemeType.BFV)
    n = 64
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [30] * 5))
    parms.set_plain_modulus(PlainModulus.batching(n, 17))
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    tool = ctx.first_context_data().galois_tool
    steps = [1, -2]
    elts = tool.get_elts_from_steps(steps)
    gk = kg.galois_keys(elts)
    ev = Evaluator(ctx)
    plan = KeySwitchPlan(ctx, ctx.first_parms_id)

    ct = enc.encrypt(Plaintext.from_hex("5x^3 + 3x^2 + 2"))
    want = ev.apply_galois_many(ct, elts, gk)

    keys_stack = gk.stacked(*elts)
    mesh = _mesh_limb(4)
    sh = NamedSharding(mesh, P(None, "limb", None))
    data = jax.device_put(np.asarray(ct.data), sh)
    out = np.asarray(
        rotate_many_limb_sharded(data, keys_stack, elts, tool, plan, mesh,
                                 is_ntt_form=False)
    )
    for i in range(len(elts)):
        np.testing.assert_array_equal(out[i], np.asarray(want[i].data))


needs8 = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")


def _mesh_dp_limb(dp, c):
    from jax.sharding import Mesh

    return Mesh(
        np.asarray(jax.devices()[: dp * c]).reshape(dp, c),
        axis_names=("dp", "limb"),
    )


@needs8
def test_dp_limb_switch_bit_exact_and_profile():
    """The recommended (dp=2, limb=4) production layout on the SAME
    one-gather schedule: batch axis dp-sharded, limbs limb-sharded,
    bit-exact vs in-core, and the collectives still name only 'limb'
    (dp moves zero bytes)."""
    ctx, kg = setup(64, [30] * 5, nsp=1)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    rk = kg.relin_keys()
    plan = KeySwitchPlan(ctx, ctx.first_parms_id)

    ct = enc.encrypt(encoder.encode([0.5, -1.25, 2.0], 2.0 ** 25))
    base = np.asarray(ct.data)[1]
    target = np.stack([base * 0 + base, np.roll(base, 1, axis=-1),
                       base, base[:, ::-1].copy()])  # batch 4, distinct
    kdata = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
    from gemini_seal.ops.keyswitch import switch_key as sk_incore

    want0, want1 = sk_incore(target, kdata, plan, True)

    mesh = _mesh_dp_limb(2, 4)
    sh = NamedSharding(mesh, P("dp", "limb", None))
    d0, d1 = switch_key_limb_sharded(
        jax.device_put(target, sh), kdata, plan, mesh
    )
    np.testing.assert_array_equal(np.asarray(d0), np.asarray(want0))
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(want1))

    fn = jax.jit(
        lambda t: switch_key_limb_sharded(t, kdata, plan, mesh),
        in_shardings=(sh,),
    )
    txt = fn.lower(jax.device_put(target, sh)).compile().as_text()
    stats = collective_stats(txt)
    assert stats.count.get("all-gather", 0) == 1, stats
    assert "all-reduce" not in stats.count, stats
    assert "collective-permute" not in stats.count, stats
    # per-device gather volume: the dp shard's slice of the target only
    assert stats.bytes["all-gather"] <= target.nbytes // 2, stats


@needs8
def test_dp_limb_full_pipeline_bit_exact():
    """mul+relin+rescale on the (dp=2, limb=4) mesh, rows bit-exact vs
    the in-core step at a realistic batched shape."""
    from gemini_seal.models.pipelines import build_ckks_mul_relin_rescale
    from gemini_seal.parallel.keyswitch_sp import (
        ckks_mul_relin_rescale_limb_sharded,
    )

    ctx, kg = setup(256, [30] * 9, nsp=1)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    rk = kg.relin_keys()
    plan = KeySwitchPlan(ctx, ctx.first_parms_id)
    n_ct = plan.n_ct_rns

    a = np.stack([
        np.asarray(enc.encrypt(encoder.encode([0.5 * (i + 1), -i], 2.0 ** 25)).data)
        for i in range(4)
    ])
    kdata = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
    want = np.asarray(jax.jit(build_ckks_mul_relin_rescale(ctx))(a, a, kdata))

    mesh = _mesh_dp_limb(2, 4)
    sh = NamedSharding(mesh, P("dp", None, "limb", None))
    da = jax.device_put(a, sh)
    out = np.asarray(
        ckks_mul_relin_rescale_limb_sharded(da, da, kdata, plan, mesh)
    )
    np.testing.assert_array_equal(out[..., : n_ct - 1, :], want)
    assert np.all(out[..., n_ct - 1, :] == 0)
