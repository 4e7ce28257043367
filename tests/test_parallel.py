"""Multi-device sharded execution on the virtual 8-device CPU mesh.

No analogue in the reference (single-threaded library, SURVEY §2.4/§5);
these tests pin the build's own parallel contract: sharded execution is
bit-exact vs the host plane, for ciphertext-batch DP, RNS-limb sharding,
and the combined (dp, limb) mesh.
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
from gemini_seal.models.pipelines import (
    build_ckks_mul_relin_rescale,
    build_ckks_train_step,
)
from gemini_seal.parallel.mesh import (
    ciphertext_sharding,
    key_sharding,
    make_he_mesh,
)

SEED = tuple(range(21, 29))


def setup(n=64, bits=(30, 30, 30, 30, 30)):
    """5 primes -> L_first = 4 limbs at the working level (divisible by 4)."""
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, list(bits)))
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    return ctx, kg


def _batch_inputs(ctx, kg, batch):
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    rk = kg.relin_keys()
    scale = 2.0 ** 25
    cts = [
        enc.encrypt(encoder.encode([0.5 * (i + 1), -0.25 * i], scale))
        for i in range(batch)
    ]
    a = np.stack([np.asarray(ct.data) for ct in cts])
    rk_data = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
    return a, rk_data, rk, cts


def _host_reference(ctx, kg, cts, rk):
    ev = Evaluator(ctx)
    return [
        np.asarray(
            ev.rescale_to_next(ev.relinearize(ev.multiply(ct, ct), rk)).data
        )
        for ct in cts
    ]


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_dp_sharded_matches_host():
    ctx, kg = setup()
    a, rk_data, rk, cts = _batch_inputs(ctx, kg, batch=8)
    want = _host_reference(ctx, kg, cts, rk)

    mesh = make_he_mesh(dp=8, limb=1)
    ct_sh = NamedSharding(mesh, P("dp", None, None, None))
    key_sh = NamedSharding(mesh, P())
    step = jax.jit(
        build_ckks_mul_relin_rescale(ctx), in_shardings=(ct_sh, ct_sh, key_sh)
    )
    out = np.asarray(step(jax.device_put(a, ct_sh), jax.device_put(a, ct_sh),
                          jax.device_put(rk_data, key_sh)))
    for i in range(8):
        np.testing.assert_array_equal(out[i], want[i])


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")
def test_limb_sharded_matches_host():
    ctx, kg = setup()
    a, rk_data, rk, cts = _batch_inputs(ctx, kg, batch=2)
    want = _host_reference(ctx, kg, cts, rk)

    mesh = make_he_mesh(n_devices=4, dp=1, limb=4)
    # shard the L axis of [batch, size, L, N]; GSPMD inserts the collectives
    # for the key-switch contraction over limbs.
    ct_sh = NamedSharding(mesh, P(None, None, "limb", None))
    key_sh = NamedSharding(mesh, P())
    step = jax.jit(
        build_ckks_mul_relin_rescale(ctx), in_shardings=(ct_sh, ct_sh, key_sh)
    )
    out = np.asarray(step(jax.device_put(a, ct_sh), jax.device_put(a, ct_sh),
                          jax.device_put(rk_data, key_sh)))
    for i in range(2):
        np.testing.assert_array_equal(out[i], want[i])


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_dp_limb_mesh_train_step():
    ctx, kg = setup()
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    ev = Evaluator(ctx)
    tool = ctx.first_context_data().galois_tool
    elt = tool.get_elt_from_step(1)
    rk = kg.relin_keys()
    gk = kg.galois_keys([elt])
    scale = 2.0 ** 25

    batch = 4
    cts = [
        enc.encrypt(encoder.encode([float(i + 1), -0.5], scale))
        for i in range(batch)
    ]
    a = np.stack([np.asarray(ct.data) for ct in cts])
    rk_data = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
    gk_data = np.stack([np.asarray(pk.data.data) for pk in gk.key(elt)])

    # host truth
    want = []
    for ct in cts:
        prod = ev.rescale_to_next(ev.relinearize(ev.multiply(ct, ct), rk))
        rot = ev.rotate_vector(prod, 1, gk)
        want.append(np.asarray(ev.add(prod, rot).data))

    mesh = make_he_mesh(dp=2, limb=4)
    ct_sh = NamedSharding(mesh, P("dp", None, "limb", None))
    key_sh = NamedSharding(mesh, P())
    step = jax.jit(
        build_ckks_train_step(ctx, rotate_steps=1),
        in_shardings=(ct_sh, ct_sh, key_sh, key_sh),
    )
    out = np.asarray(step(jax.device_put(a, ct_sh), jax.device_put(a, ct_sh),
                          jax.device_put(rk_data, key_sh),
                          jax.device_put(gk_data, key_sh)))
    for i in range(batch):
        np.testing.assert_array_equal(out[i], want[i])


def test_sharding_helpers():
    mesh = make_he_mesh(dp=2, limb=4)
    assert mesh.shape == {"dp": 2, "limb": 4}
    ct_sh = ciphertext_sharding(mesh)
    assert ct_sh.spec == P("dp", None, "limb", None)
    k_sh = key_sharding(mesh)
    assert k_sh.spec == P(None, None, "limb", None)
