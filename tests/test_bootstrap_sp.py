"""Multi-chip bootstrap: limb-sharded C2S/S2C matvec + dp-sharded refresh.

- build_ckks_matvec_limb_sharded (parallel/bootstrap_sp.py) is bit-exact
  vs the in-core fused hoisted matvec on the virtual mesh, for synthetic
  diagonals AND a real bootstrap CoeffToSlot group;
- its compiled HLO carries exactly ONE all_gather (the hoisted mod-up
  target) bounded by n_ct * N * 8 bytes — the one-gather schedule,
  shared with keyswitch_sp;
- the composed refresh is batch-polymorphic: ciphertext-batch dp
  sharding moves ZERO bytes (HLO guard on the stage program), and the
  gated e2e (GST_BOOTSTRAP_E2E=1) refreshes a dp-sharded batch on a
  (dp=2, limb=1) mesh decrypt-equal to the unsharded path.

No reference analogue (no bootstrap, no multi-device execution in the
fork; SURVEY §2.4 / §5).
"""

import math

import numpy as np
import pytest

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gemini_seal import (
    CKKSEncoder,
    CoeffModulus,
    Decryptor,
    EncryptionParameters,
    Encryptor,
    Evaluator,
    KeyGenerator,
    SchemeType,
    SealContext,
    SecLevelType,
)
from gemini_seal.ciphertext import Ciphertext
from gemini_seal.models.pipelines import build_ckks_matvec
from gemini_seal.parallel.bootstrap_sp import build_ckks_matvec_limb_sharded
from gemini_seal.parallel.comm import assert_collectives, collective_stats

needs8 = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _ckks_context(n, bits, nsp=1, seed=(1, 2, 3, 4, 5, 6, 7, 8)):
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, bits))
    parms.set_n_special_primes(nsp)
    parms.set_random_seed(seed)
    return SealContext(parms, sec_level=SecLevelType.none)


@needs8
def test_matvec_limb_sharded_bitexact():
    """Synthetic 4-diagonal matvec, nsp=2 hybrid keys, limb=4: rows
    identical to the in-core fused path, one bounded all_gather."""
    n = 64
    ctx = _ckks_context(n, [30] * 10, nsp=2)
    cd = ctx.first_context_data()
    n_ct = len(cd.parms.coeff_modulus)
    assert n_ct == 8
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    s = encoder.slot_count
    rng = np.random.default_rng(3)
    diag = {
        d: (rng.uniform(-1, 1, s) + 1j * rng.uniform(-1, 1, s)).tolist()
        for d in (0, 1, 3, -2)
    }
    scale = 2.0 ** 25
    tool = cd.galois_tool
    rot_steps = [d for d in sorted(diag) if d != 0]
    elts = [tool.get_elt_from_step(d) for d in rot_steps]
    gk = kg.galois_keys(elts)
    keys = np.asarray(gk.stacked(*elts))
    ct = enc.encrypt(encoder.encode(
        (rng.uniform(-1, 1, s) + 1j * rng.uniform(-1, 1, s)).tolist(),
        scale))
    a = np.asarray(ct.data)

    want = np.asarray(jax.jit(
        build_ckks_matvec(ctx, diag, scale, encoder))(a, keys))

    mesh = Mesh(np.asarray(jax.devices()[:4]), axis_names=("limb",))
    fn = build_ckks_matvec_limb_sharded(ctx, diag, scale, encoder, mesh)
    da = jax.device_put(a, NamedSharding(mesh, P(None, "limb", None)))
    got = np.asarray(fn(da, keys))
    np.testing.assert_array_equal(got, want)

    # one-gather schedule: a single all-gather, bounded by the full
    # inverse-NTT'd target (n_ct rows) — NOT the nb*n_ext digit tensor
    stats = assert_collectives(
        fn.compiled_text(da, keys),
        require_any=("all-gather",),
        max_allgather_bytes=n_ct * n * 8,
    )
    assert stats.count.get("all-gather", 0) == 1, str(stats)


@needs8
def test_bootstrap_c2s_group_limb_sharded():
    """A REAL CoeffToSlot group (split mode, radix 2, constants folded as
    in build_ckks_bootstrap) runs limb-sharded bit-exact: the bootstrap's
    linear stages shard with the same one-gather schedule as serving."""
    from gemini_seal.models.bootstrap import (
        _collapse_chain,
        _scale_diagonals,
        special_fft_stage_diagonals,
    )

    n = 64
    ctx = _ckks_context(n, [40] * 9, nsp=1)
    cd = ctx.first_context_data()
    n_ct = len(cd.parms.coeff_modulus)
    assert n_ct == 8
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    s = encoder.slots
    fwd_st, inv_st = special_fft_stage_diagonals(encoder)
    groups = _collapse_chain(list(reversed(inv_st)), s, 2)
    # the first C2S group with a bootstrap-like folded constant
    diag = _scale_diagonals(groups[0], 0.25 + 0.1j)
    scale = float(cd.parms.coeff_modulus[-1].value)  # scale-preserving

    tool = cd.galois_tool
    rot_steps = [d for d in sorted(diag) if d != 0]
    elts = [tool.get_elt_from_step(d) for d in rot_steps]
    gk = kg.galois_keys(elts)
    keys = np.asarray(gk.stacked(*elts))
    rng = np.random.default_rng(11)
    ct = enc.encrypt(encoder.encode(
        (rng.uniform(-1, 1, s) + 1j * rng.uniform(-1, 1, s)).tolist(),
        2.0 ** 30))
    a = np.asarray(ct.data)

    want = np.asarray(jax.jit(
        build_ckks_matvec(ctx, diag, scale, encoder))(a, keys))
    mesh = Mesh(np.asarray(jax.devices()[:8]), axis_names=("limb",))
    fn = build_ckks_matvec_limb_sharded(ctx, diag, scale, encoder, mesh)
    da = jax.device_put(a, NamedSharding(mesh, P(None, "limb", None)))
    got = np.asarray(fn(da, keys))
    np.testing.assert_array_equal(got, want)
    stats = assert_collectives(
        fn.compiled_text(da, keys),
        require_any=("all-gather",),
        max_allgather_bytes=n_ct * n * 8,
    )
    assert stats.count.get("all-gather", 0) == 1, str(stats)


@needs8
def test_bootstrap_stage_dp_sharded_zero_collectives():
    """Ciphertext-batch DP over a bootstrap linear stage moves ZERO bytes:
    the matvec program is batch-polymorphic and dp is a free axis."""
    from gemini_seal.parallel.mesh import make_he_mesh

    n = 64
    ctx = _ckks_context(n, [40] * 9, nsp=1)
    cd = ctx.first_context_data()
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    s = encoder.slot_count
    rng = np.random.default_rng(7)
    diag = {
        d: (rng.uniform(-1, 1, s) + 1j * rng.uniform(-1, 1, s)).tolist()
        for d in (0, 1, -1)
    }
    scale = 2.0 ** 25
    tool = cd.galois_tool
    rot_steps = [d for d in sorted(diag) if d != 0]
    elts = [tool.get_elt_from_step(d) for d in rot_steps]
    gk = kg.galois_keys(elts)
    keys = np.asarray(gk.stacked(*elts))
    ct = enc.encrypt(encoder.encode([0.5] * s, scale))
    batch = 8
    a = np.broadcast_to(np.asarray(ct.data), (batch,) + ct.data.shape)

    mesh = make_he_mesh(dp=8, limb=1)
    ct_sh = NamedSharding(mesh, P("dp", None, None, None))
    key_sh = NamedSharding(mesh, P())
    step = jax.jit(build_ckks_matvec(ctx, diag, scale, encoder),
                   in_shardings=(ct_sh, key_sh))
    da = jax.device_put(a, ct_sh)
    dk = jax.device_put(keys, key_sh)
    stats = collective_stats(step.lower(da, dk).compile().as_text())
    assert stats.total_bytes == 0, f"unexpected collective traffic: {stats}"
    # rows identical to the unsharded program
    want = np.asarray(jax.jit(
        build_ckks_matvec(ctx, diag, scale, encoder))(a[0], keys))
    np.testing.assert_array_equal(np.asarray(step(da, dk))[0], want)


@pytest.mark.bootstrap_e2e
@needs8
def test_bootstrap_dp_sharded_refresh_e2e():
    """Full composed refresh (split + cosine, N=128) over a dp-sharded
    batch: both batch rows decrypt to the refreshed message, identical to
    each other and within the e2e tolerance — the flagship capability
    scales over the batch axis with zero schedule changes."""
    from gemini_seal.models.bootstrap import (
        build_ckks_bootstrap,
        plan_bootstrap_chain,
    )
    from gemini_seal.parallel.mesh import make_he_mesh

    n, radix = 128, 3
    bits, n_levels, K = plan_bootstrap_chain(n, radix=radix, nsp=1)
    ctx = _ckks_context(n, bits)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    ev = Evaluator(ctx)
    tool = ctx.first_context_data().galois_tool
    scale = 2.0 ** 45

    fn, out_pid, out_scale, rot_steps, conj_elt = build_ckks_bootstrap(
        ctx, scale, encoder, linear_mode="split", radix=radix)
    elts = [tool.get_elt_from_step(st) for st in rot_steps]
    gk = kg.galois_keys(elts + [conj_elt])
    rot_stack = gk.stacked(*elts)
    conj_stack = gk.stacked(conj_elt)
    rks = kg.relin_keys().stacked(2)

    rng = np.random.default_rng(13)
    s = encoder.slot_count
    msg = rng.uniform(-1, 1, s) + 1j * rng.uniform(-1, 1, s)
    ct = enc.encrypt(encoder.encode(msg.tolist(), scale))
    while ctx.get_context_data(ct.parms_id).next_context_data is not None:
        ct = ev.mod_switch_to_next(ct)

    batch = 2
    a = np.broadcast_to(np.asarray(ct.data), (batch,) + ct.data.shape)
    mesh = make_he_mesh(n_devices=2, dp=2, limb=1)
    ct_sh = NamedSharding(mesh, P("dp", None, None, None))
    key_sh = NamedSharding(mesh, P())
    da = jax.device_put(a, ct_sh)
    out = np.asarray(fn(da, jax.device_put(np.asarray(rot_stack), key_sh),
                        jax.device_put(np.asarray(conj_stack), key_sh),
                        jax.device_put(np.asarray(rks), key_sh)))
    assert out.shape[0] == batch
    np.testing.assert_array_equal(out[0], out[1])
    got = np.asarray(encoder.decode(dec.decrypt(
        Ciphertext(out[0], out_pid, True, out_scale)), as_complex=True))[:s]
    err = np.abs(got - msg).max()
    assert err < 1e-6, f"dp-sharded refresh error {err:.2e}"
