"""Compile-time guards against silent de-parallelization, plus sharded
bit-exactness at REALISTIC shapes (N=4096, L=8 + nsp=2, batch=8).

Bit-exactness tests cannot distinguish a genuinely limb-sharded program
from one XLA quietly de-parallelized by all-gathering the limb axis; the
compiled-HLO collective profile can (mirrors test_ntt_sp's NTT-SP guard).
The legitimate cross-device traffic of a hybrid key switch is bounded:
mod-up may all-gather the power-basis TARGET limbs (every bundle's CRT
interpolation reads every limb of its bundle), but never the extended
digit tensor [nb, n_ext, N] — that is the contraction input whose
replication would serialize the key-switch (SURVEY §2.4; rns.cpp:452-523).
"""

import numpy as np
import pytest

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from gemini_seal import (
    CKKSEncoder,
    CoeffModulus,
    EncryptionParameters,
    Encryptor,
    Evaluator,
    KeyGenerator,
    SchemeType,
    SecLevelType,
    SealContext,
)
from gemini_seal.models.pipelines import build_ckks_mul_relin_rescale
from gemini_seal.parallel.comm import assert_collectives, collective_stats
from gemini_seal.parallel.mesh import make_he_mesh

SEED = tuple(range(51, 59))

needs8 = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


def make_ctx(n, bits, nsp=1):
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, list(bits)))
    parms.set_n_special_primes(nsp)
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    return ctx, KeyGenerator(ctx)


def _inputs(ctx, kg, batch, scale=2.0 ** 25):
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    rk = kg.relin_keys()
    cts = [
        enc.encrypt(encoder.encode([0.5 * (i + 1), -0.25 * i, 1.0 / (i + 2)], scale))
        for i in range(batch)
    ]
    a = np.stack([np.asarray(ct.data) for ct in cts])
    rk_data = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
    return a, rk_data, rk, cts


def _compile_limb_sharded(ctx, a, rk_data, dp, limb, fused=False):
    mesh = make_he_mesh(n_devices=dp * limb, dp=dp, limb=limb)
    ct_sh = NamedSharding(mesh, P("dp" if dp > 1 else None, None, "limb", None))
    key_sh = NamedSharding(mesh, P())
    step = jax.jit(
        build_ckks_mul_relin_rescale(ctx, fused=fused),
        in_shardings=(ct_sh, ct_sh, key_sh),
    )
    da = jax.device_put(a, ct_sh)
    dk = jax.device_put(rk_data, key_sh)
    compiled = step.lower(da, da, dk).compile()
    return compiled, da, dk


@needs8
def test_limb_sharded_collective_guard():
    """The limb-sharded mul+relin+rescale must contain real reduction
    collectives, and no all-gather larger than the full ciphertext tensor
    (the digit tensor [nb, n_ext, N] is bigger — replicating it would be
    the de-parallelized program)."""
    ctx, kg = make_ctx(64, [30] * 5)
    a, rk_data, _, _ = _inputs(ctx, kg, batch=2)
    for fused in (False, True):
        compiled, _, _ = _compile_limb_sharded(ctx, a, rk_data, 1, 4, fused)
        stats = assert_collectives(
            compiled.as_text(),
            require_any=("all-reduce", "reduce-scatter", "collective-permute"),
            max_allgather_bytes=a.nbytes,
        )
        assert stats.total_bytes > 0


@needs8
def test_dp_sharded_zero_collectives():
    """Pure ciphertext-batch DP is embarrassingly parallel: the compiled
    program must move ZERO bytes between devices."""
    ctx, kg = make_ctx(64, [30] * 5)
    a, rk_data, _, _ = _inputs(ctx, kg, batch=8)
    mesh = make_he_mesh(dp=8, limb=1)
    ct_sh = NamedSharding(mesh, P("dp", None, None, None))
    key_sh = NamedSharding(mesh, P())
    step = jax.jit(
        build_ckks_mul_relin_rescale(ctx), in_shardings=(ct_sh, ct_sh, key_sh)
    )
    da = jax.device_put(a, ct_sh)
    dk = jax.device_put(rk_data, key_sh)
    stats = collective_stats(step.lower(da, da, dk).compile().as_text())
    assert stats.total_bytes == 0, f"unexpected collective traffic: {stats}"


@needs8
def test_realistic_shape_dp_limb_sharded_bit_exact():
    """(dp=2, limb=4) mesh at a REAL serving shape: N=4096, L=8 working
    limbs + nsp=2 special primes, batch 8 — shard/bundle-boundary bugs and
    GSPMD partitioning decisions change with shape, so toy-shape passes do
    not cover this."""
    ctx, kg = make_ctx(4096, [30] * 10, nsp=2)
    cd = ctx.first_context_data()
    assert len(cd.parms.coeff_modulus) == 8
    a, rk_data, rk, cts = _inputs(ctx, kg, batch=8)

    compiled, da, dk = _compile_limb_sharded(ctx, a, rk_data, dp=2, limb=4)
    # the de-parallelization bound scales with the shape: digit tensor is
    # nb*n_ext = 4*10 limb-rows vs the ciphertext's 2*8
    assert_collectives(
        compiled.as_text(),
        require_any=("all-reduce", "reduce-scatter", "collective-permute"),
        max_allgather_bytes=a.nbytes,
    )

    out = np.asarray(compiled(da, da, dk))
    ev = Evaluator(ctx)
    for i in range(8):
        want = np.asarray(
            ev.rescale_to_next(ev.relinearize(ev.multiply(cts[i], cts[i]), rk)).data
        )
        np.testing.assert_array_equal(out[i], want)


def test_cnn_dp_sharded_zero_collectives_and_bit_exact():
    """The whole encrypted CNN under pure ciphertext-batch DP: zero
    collective bytes in the compiled program, rows identical to the unsharded step
    (encrypted inference scale-out is a free axis)."""
    from gemini_seal.models.pipelines import build_ckks_cnn

    ctx, kg = make_ctx(256, [50, 40, 40, 40, 50])
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    tool = ctx.first_context_data().galois_tool
    rk = kg.relin_keys()
    scale = 2.0 ** 40
    h = w = 4
    hw = h * w
    rng = np.random.default_rng(3)
    kern = rng.uniform(-0.4, 0.4, size=(3, 3))
    slots = encoder.slot_count
    readout = {
        d: [rng.uniform(-0.3, 0.3) for _ in range(slots)] for d in (0, 1, 3)
    }
    fn, out_pid, out_scale = build_ckks_cnn(
        ctx, convs=[(kern, None, "square")],
        dense=[(readout, [0.0] * slots, None)],
        height=h, width=w, scale=scale, encoder=encoder, bsgs=True,
    )
    gk_stacks = []
    for layer_steps in fn.rot_steps:
        elts = [tool.get_elt_from_step(s) for s in layer_steps]
        gk = kg.galois_keys(elts)
        gk_stacks.append(gk.stacked(*elts))
    rk_data = rk.stacked(2)

    imgs = [rng.uniform(0, 1, size=hw) for _ in range(8)]
    cts = [
        enc.encrypt(encoder.encode(
            [im[i % hw] for i in range(slots)], scale))
        for im in imgs
    ]
    a = np.stack([np.asarray(ct.data) for ct in cts])

    mesh = make_he_mesh(dp=8, limb=1)
    ct_sh = NamedSharding(mesh, P("dp", None, None, None))
    key_sh = NamedSharding(mesh, P())
    nst = len(gk_stacks)
    step = jax.jit(
        lambda c, r, *gs: fn(c, gs, r),
        in_shardings=(ct_sh, key_sh) + (key_sh,) * nst,
    )
    da = jax.device_put(a, ct_sh)
    dks = [jax.device_put(g, key_sh) for g in gk_stacks]
    dr = jax.device_put(rk_data, key_sh)
    compiled = step.lower(da, dr, *dks).compile()
    stats = collective_stats(compiled.as_text())
    assert stats.total_bytes == 0, f"unexpected collective traffic: {stats}"

    out = np.asarray(compiled(da, dr, *dks))
    want = np.asarray(jax.jit(lambda c, r, *gs: fn(c, gs, r))(a, rk_data,
                                                              *gk_stacks))
    np.testing.assert_array_equal(out, want)


@needs8
def test_matmul_dp_sharded_zero_collectives_and_bit_exact():
    """The encrypted matrix product under pure ciphertext-batch DP:
    zero interconnect bytes (batched matmul serving scales out freely) and rows
    identical to the unsharded program."""
    from gemini_seal.models.pipelines import build_ckks_matmul_square

    ctx, kg = make_ctx(32, [50, 40, 40, 40, 40, 50])
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    tool = ctx.first_context_data().galois_tool
    scale = 2.0 ** 40
    d = 4
    fn, out_pid, out_scale = build_ckks_matmul_square(ctx, d, scale, encoder)
    elts = [tool.get_elt_from_step(s) for s in fn.rot_steps]
    gk = kg.galois_keys(elts)
    gk_stack = gk.stacked(*elts)
    rk_data = kg.relin_keys().stacked(2)

    rng = np.random.default_rng(7)
    a = np.stack([
        np.asarray(enc.encrypt(encoder.encode(
            rng.uniform(-1, 1, d * d).tolist(), scale)).data)
        for _ in range(8)
    ])
    b = np.stack([
        np.asarray(enc.encrypt(encoder.encode(
            rng.uniform(-1, 1, d * d).tolist(), scale)).data)
        for _ in range(8)
    ])

    mesh = make_he_mesh(dp=8, limb=1)
    ct_sh = NamedSharding(mesh, P("dp", None, None, None))
    key_sh = NamedSharding(mesh, P())
    step = jax.jit(fn, in_shardings=(ct_sh, ct_sh, key_sh, key_sh))
    da = jax.device_put(a, ct_sh)
    db = jax.device_put(b, ct_sh)
    dg = jax.device_put(gk_stack, key_sh)
    dr = jax.device_put(rk_data, key_sh)
    compiled = step.lower(da, db, dg, dr).compile()
    stats = collective_stats(compiled.as_text())
    assert stats.total_bytes == 0, f"unexpected collective traffic: {stats}"

    out = np.asarray(compiled(da, db, dg, dr))
    want = np.asarray(jax.jit(fn)(a, b, gk_stack, rk_data))
    np.testing.assert_array_equal(out, want)


@needs8
def test_matmul_limb_sharded_bit_exact():
    """The encrypted matmul under a (dp=2, limb=4) mesh: GSPMD must keep
    real reduction collectives (no silent de-parallelization into a
    giant all-gather of the digit tensors) and the rows must stay
    bit-exact vs the unsharded program."""
    from gemini_seal.models.pipelines import build_ckks_matmul_square

    ctx, kg = make_ctx(32, [30] * 9)
    cd = ctx.first_context_data()
    assert len(cd.parms.coeff_modulus) % 4 == 0  # L = 8 splits over limb=4
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    tool = cd.galois_tool
    scale = 2.0 ** 25
    d = 4
    fn, out_pid, out_scale = build_ckks_matmul_square(ctx, d, scale, encoder)
    elts = [tool.get_elt_from_step(s) for s in fn.rot_steps]
    gk = kg.galois_keys(elts)
    gk_stack = gk.stacked(*elts)
    rk_data = kg.relin_keys().stacked(2)

    rng = np.random.default_rng(13)
    a = np.stack([
        np.asarray(enc.encrypt(encoder.encode(
            rng.uniform(-1, 1, d * d).tolist(), scale)).data)
        for _ in range(2)
    ])
    b = np.stack([
        np.asarray(enc.encrypt(encoder.encode(
            rng.uniform(-1, 1, d * d).tolist(), scale)).data)
        for _ in range(2)
    ])

    mesh = make_he_mesh(dp=2, limb=4)
    ct_sh = NamedSharding(mesh, P("dp", None, "limb", None))
    key_sh = NamedSharding(mesh, P())
    step = jax.jit(fn, in_shardings=(ct_sh, ct_sh, key_sh, key_sh))
    da = jax.device_put(a, ct_sh)
    db = jax.device_put(b, ct_sh)
    dg = jax.device_put(gk_stack, key_sh)
    dr = jax.device_put(rk_data, key_sh)
    compiled = step.lower(da, db, dg, dr).compile()
    stats = assert_collectives(
        compiled.as_text(),
        require_any=("all-reduce", "reduce-scatter", "collective-permute"),
        max_allgather_bytes=a.nbytes + b.nbytes,
    )
    assert stats.total_bytes > 0

    out = np.asarray(compiled(da, db, dg, dr))
    want = np.asarray(jax.jit(fn)(a, b, gk_stack, rk_data))
    np.testing.assert_array_equal(out, want)
