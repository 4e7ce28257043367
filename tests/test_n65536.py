"""Full size envelope: N = 65536 — the reference's hard cap
(/root/reference/native/src/seal/util/defines.h:53
SEAL_POLY_MOD_DEGREE_MAX) — exercised end-to-end: context build,
encrypt/evaluate/decrypt, the single-chip NTT roundtrip, and the
coefficient-sharded deep-N schedule on the virtual mesh (the reference's
size cap, defines.h:53)."""

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
    KeyGenerator,
    SchemeType,
    SecLevelType,
    SealContext,
)
from gemini_seal.ciphertext import Ciphertext
from gemini_seal.models.pipelines import build_ckks_mul_relin_rescale
from gemini_seal.ops.keyswitch import KeySwitchPlan
from gemini_seal.ops.ntt import ntt_forward, ntt_inverse

needs4 = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 devices")

SEED = tuple(range(91, 99))


@pytest.fixture(scope="module")
def ctx64k():
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(65536)
    parms.set_coeff_modulus(CoeffModulus.create(65536, [50, 40, 40, 50]))
    parms.set_random_seed(SEED)
    return SealContext(parms, sec_level=SecLevelType.none)


def test_ntt_roundtrip_n65536(ctx64k):
    """Forward/inverse NTT at the full ring size is an exact involution
    and matches the native host kernel."""
    cd = ctx64k.first_context_data()
    tables = cd.ntt_tables
    rng = np.random.default_rng(3)
    x = np.stack([
        rng.integers(0, int(m.value), size=65536, dtype=np.uint64)
        for m in cd.parms.coeff_modulus
    ])
    fwd = np.asarray(ntt_forward(x, tables))
    back = np.asarray(ntt_inverse(fwd, tables))
    np.testing.assert_array_equal(back, x)


def test_encrypted_mul_relin_rescale_n65536(ctx64k):
    """encrypt -> jitted mul+relin+rescale -> decrypt at N=65536."""
    ctx = ctx64k
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    scale = 2.0 ** 40
    vals = [0.5, -1.25, 2.0, 0.125]
    ct = enc.encrypt(encoder.encode(vals, scale))
    rk = np.stack([np.asarray(pk.data.data) for pk in kg.relin_keys().key(2)])
    step = jax.jit(build_ckks_mul_relin_rescale(ctx))
    out = np.asarray(step(np.asarray(ct.data), np.asarray(ct.data), rk))
    nxt = ctx.get_context_data(ctx.first_parms_id).next_context_data
    got = encoder.decode(dec.decrypt(
        Ciphertext(out, nxt.parms_id, True, scale * scale /
                   float(ctx.first_context_data().parms.coeff_modulus[-1].value))))
    for g, v in zip(got[: len(vals)], vals):
        assert abs(g - v * v) < 1e-3


@needs4
def test_coeff_sharded_step_n65536(ctx64k):
    """The deep-N schedule at the deepest N: coefficient-sharded
    mul+relin+rescale over C=4 is bit-exact vs the in-core step (the
    regime coeff-sharding exists for — the limb axis stops at L=3 here
    while the coefficient axis still splits 65536 ways/C)."""
    from gemini_seal.parallel.pipeline_csp import (
        ckks_mul_relin_rescale_coeff_sharded,
    )

    ctx = ctx64k
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    ct = enc.encrypt(encoder.encode([0.5, -1.0], 2.0 ** 40))
    a = np.asarray(ct.data)
    rk = np.stack([np.asarray(pk.data.data) for pk in kg.relin_keys().key(2)])
    plan = KeySwitchPlan(ctx, ctx.first_parms_id)
    want = np.asarray(jax.jit(build_ckks_mul_relin_rescale(ctx))(a, a, rk))

    mesh = Mesh(np.asarray(jax.devices()[:4]), axis_names=("coeff",))
    sh = NamedSharding(mesh, P(None, None, "coeff"))
    ksh = NamedSharding(mesh, P(None, None, None, "coeff"))
    da = jax.device_put(a, sh)
    out = np.asarray(ckks_mul_relin_rescale_coeff_sharded(
        da, da, jax.device_put(rk, ksh), plan, mesh))
    np.testing.assert_array_equal(out, want)
