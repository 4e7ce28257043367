"""Guards for the collective-byte model (tools/scaling_model.py).

The model's byte formulas must match the compiled HLO of the shipped
schedules at the virtual-mesh-measurable shape — otherwise the byte
table silently drifts from the code it claims to describe.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

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
from gemini_seal.ops.keyswitch import KeySwitchPlan
from gemini_seal.parallel.comm import collective_stats

needs8 = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
needs4 = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 devices")


def _setup(n=4096, n_primes=10, nsp=2):
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [30] * n_primes))
    parms.set_n_special_primes(nsp)
    parms.set_random_seed(tuple(range(41, 49)))
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    rk = kg.relin_keys()
    a = np.asarray(enc.encrypt(encoder.encode([0.5, -1.0], 2.0 ** 25)).data)
    kdata = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
    return ctx, a, kdata


@needs4
def test_explicit_bytes_formula_matches_hlo():
    """bytes_explicit == the compiled HLO's collective bytes, exactly:
    one all-gather of the [b, n_ct, N] target + one [b, 2, 1, N]
    all-reduce (q_last broadcast) = b*(n_ct+2)*N*8."""
    from scaling_model import bytes_explicit

    from gemini_seal.parallel.keyswitch_sp import (
        ckks_mul_relin_rescale_limb_sharded,
    )

    batch = 8
    ctx, a, kdata = _setup()
    plan = KeySwitchPlan(ctx, ctx.first_parms_id)
    n_ct, N = plan.n_ct_rns, a.shape[-1]
    ab = np.broadcast_to(a, (batch,) + a.shape)

    mesh = Mesh(np.asarray(jax.devices()[:4]), axis_names=("limb",))
    sh = NamedSharding(mesh, P(None, None, "limb", None))
    da = jax.device_put(ab, sh)
    fn = jax.jit(
        lambda x, y: ckks_mul_relin_rescale_limb_sharded(
            x, y, kdata, plan, mesh),
        in_shardings=(sh, sh),
    )
    stats = collective_stats(fn.lower(da, da).compile().as_text())
    want, n_coll = bytes_explicit(batch, n_ct, 1, N, 4)
    assert sum(stats.count.values()) == n_coll, stats
    assert stats.total_bytes == want, (stats.total_bytes, want)


@needs4
def test_csp_bytes_formula_matches_hlo():
    """bytes_csp (16 transposes of the local shard) matches the
    coeff-sharded step's HLO all_to_all result bytes within 10%."""
    from scaling_model import bytes_csp

    from gemini_seal.parallel.pipeline_csp import (
        ckks_mul_relin_rescale_coeff_sharded,
    )

    batch = 8
    C = 4
    ctx, a, kdata = _setup()
    plan = KeySwitchPlan(ctx, ctx.first_parms_id)
    n_ct, nsp = plan.n_ct_rns, plan.n_ext - plan.n_ct_rns
    N = a.shape[-1]
    ab = np.broadcast_to(a, (batch,) + a.shape)

    mesh = Mesh(np.asarray(jax.devices()[:C]), axis_names=("coeff",))
    sh = NamedSharding(mesh, P(None, None, None, "coeff"))
    ksh = NamedSharding(mesh, P(None, None, None, "coeff"))
    da = jax.device_put(ab, sh)
    dk = jax.device_put(kdata, ksh)
    fn = jax.jit(
        lambda x, y, k: ckks_mul_relin_rescale_coeff_sharded(
            x, y, k, plan, mesh),
        in_shardings=(sh, sh, ksh),
    )
    stats = collective_stats(fn.lower(da, da, dk).compile().as_text())
    got = stats.bytes.get("all-to-all", 0)
    want, _ = bytes_csp(batch, n_ct, nsp, N, C)
    assert abs(got - want) / want < 0.10, (got, want)


@needs8
def test_gspmd_bytes_anchor():
    """bytes_gspmd's fitted kappa stays within 25% of the GSPMD HLO at
    the (dp=2, limb=4) anchor — XLA partitioner drift fails loudly here
    rather than silently invalidating the prediction."""
    from scaling_model import bytes_gspmd

    from gemini_seal.models.pipelines import build_ckks_mul_relin_rescale
    from gemini_seal.parallel.mesh import make_he_mesh

    batch = 8
    ctx, a, kdata = _setup()
    plan = KeySwitchPlan(ctx, ctx.first_parms_id)
    n_ct, nsp = plan.n_ct_rns, plan.n_ext - plan.n_ct_rns
    N = a.shape[-1]
    ab = np.broadcast_to(a, (batch,) + a.shape)

    mesh = make_he_mesh(devices=jax.devices()[:8], dp=2, limb=4)
    sh = NamedSharding(mesh, P("dp", None, "limb", None))
    ksh = NamedSharding(mesh, P())
    da = jax.device_put(ab, sh)
    dk = jax.device_put(kdata, ksh)
    step = build_ckks_mul_relin_rescale(ctx)
    fn = jax.jit(step, in_shardings=(sh, sh, ksh))
    stats = collective_stats(fn.lower(da, da, dk).compile().as_text())
    # per latency slice: b = batch/dp
    want, _ = bytes_gspmd(batch // 2, n_ct, nsp, N, 4)
    assert abs(stats.total_bytes - want) / want < 0.25, \
        (stats.total_bytes, want)

@needs4
def test_behz_bytes_formula_matches_hlo():
    """bytes_behz == the BEHZ five-gather schedule's HLO all-gather
    bytes, exactly: 11 polynomial planes of [b, n_ct, N] over 5
    collectives (2 operand extends, fast_floor, fastbconv_sk, relin
    target)."""
    from scaling_model import bytes_behz

    from gemini_seal import BatchEncoder, PlainModulus
    from gemini_seal.parallel.behz_sp import bfv_mul_relin_limb_sharded

    batch = 2
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(2048)
    parms.set_coeff_modulus(CoeffModulus.create(2048, [30] * 9))
    parms.set_plain_modulus(PlainModulus.batching(2048, 20).value)
    parms.set_random_seed(tuple(range(41, 49)))
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    be = BatchEncoder(ctx)
    rk = kg.relin_keys()
    a = np.asarray(enc.encrypt(be.encode([3, 1, 4])).data)
    kdata = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
    plan = KeySwitchPlan(ctx, ctx.first_parms_id)
    n_ct, N = plan.n_ct_rns, a.shape[-1]
    ab = np.broadcast_to(a, (batch,) + a.shape)

    mesh = Mesh(np.asarray(jax.devices()[:4]), axis_names=("limb",))
    sh = NamedSharding(mesh, P(None, None, "limb", None))
    da = jax.device_put(ab, sh)
    fn = jax.jit(
        lambda x, y: bfv_mul_relin_limb_sharded(x, y, kdata, ctx, mesh),
        in_shardings=(sh, sh),
    )
    stats = collective_stats(fn.lower(da, da).compile().as_text())
    want, n_coll = bytes_behz(batch, n_ct, 1, N, 4)
    assert stats.count.get("all-gather", 0) == n_coll, stats
    assert sum(stats.count.values()) == n_coll, stats
    assert stats.total_bytes == want, (stats.total_bytes, want)


@needs4
def test_gspmd_bfv_bytes_anchor():
    """bytes_gspmd_bfv's fitted kappa stays within 25% of the GSPMD HLO
    of the in-core BEHZ multiply+relin at the limb=4 anchor shape."""
    from scaling_model import bytes_gspmd_bfv

    from gemini_seal import BatchEncoder, PlainModulus
    from gemini_seal.models.pipelines import build_bfv_mul_relin

    batch = 2
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(2048)
    parms.set_coeff_modulus(CoeffModulus.create(2048, [30] * 9))
    parms.set_plain_modulus(PlainModulus.batching(2048, 20).value)
    parms.set_random_seed(tuple(range(41, 49)))
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    be = BatchEncoder(ctx)
    rk = kg.relin_keys()
    a = np.asarray(enc.encrypt(be.encode([3, 1, 4])).data)
    kdata = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
    plan = KeySwitchPlan(ctx, ctx.first_parms_id)
    n_ct, nsp = plan.n_ct_rns, plan.n_ext - plan.n_ct_rns
    N = a.shape[-1]
    ab = np.broadcast_to(a, (batch,) + a.shape)

    mesh = Mesh(np.asarray(jax.devices()[:4]), axis_names=("limb",))
    sh = NamedSharding(mesh, P(None, None, "limb", None))
    ksh = NamedSharding(mesh, P())
    da = jax.device_put(ab, sh)
    dk = jax.device_put(kdata, ksh)
    step = build_bfv_mul_relin(ctx)
    fn = jax.jit(step, in_shardings=(sh, sh, ksh))
    stats = collective_stats(fn.lower(da, da, dk).compile().as_text())
    want, _ = bytes_gspmd_bfv(batch, n_ct, nsp, N, 4)
    assert abs(stats.total_bytes - want) / want < 0.25, \
        (stats.total_bytes, want)
