"""Example 10: sharded serving over a multi-device mesh.

The three explicit multi-device schedules of the parallel plane, on the
real devices when at least 4 exist:

1. (dp, limb=4) mesh — the CKKS hot step on the explicit ONE-all-gather
   schedule (parallel/keyswitch_sp.py), batch axis data-parallel at zero
   interconnect cost (dp=2 with 8 devices, dp=1 with 4);
2. BFV BEHZ multiply+relinearize in exactly FIVE all-gathers
   (parallel/behz_sp.py);
3. coefficient-sharded deep-N layout (parallel/pipeline_csp.py) — the
   four-step all_to_all NTT composed through the whole step.

Every result is checked bit-exact against the in-core pipeline.

Usage: python ex10_sharded_serving.py            (on 4 or more GPUs)
On a machine without them, run it on 8 virtual CPU devices:
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python ex10_sharded_serving.py
"""

import numpy as np

from common import print_parameters

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gemini_seal import (
    CKKSEncoder,
    CoeffModulus,
    EncryptionParameters,
    Encryptor,
    KeyGenerator,
    PlainModulus,
    Plaintext,
    SchemeType,
    SecLevelType,
    SealContext,
)
from gemini_seal.models.pipelines import (
    build_bfv_mul_relin,
    build_ckks_mul_relin_rescale,
)
from gemini_seal.ops.keyswitch import KeySwitchPlan
from gemini_seal.parallel.behz_sp import bfv_mul_relin_limb_sharded
from gemini_seal.parallel.keyswitch_sp import (
    ckks_mul_relin_rescale_limb_sharded,
)
from gemini_seal.parallel.pipeline_csp import (
    ckks_mul_relin_rescale_coeff_sharded,
)


def ckks_ctx(n, bits, nsp=1):
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, bits))
    parms.set_n_special_primes(nsp)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    return ctx, KeyGenerator(ctx)


def main():
    devices = jax.devices()
    if len(devices) < 4:
        raise SystemExit("needs 4 devices; see the docstring for running "
                         "on virtual CPU devices")
    dp = 2 if len(devices) >= 8 else 1

    # ---- 1) (dp, limb=4): explicit one-gather CKKS hot step ------------
    ctx, kg = ckks_ctx(1024, [30] * 9, nsp=1)
    print_parameters(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    rk = kg.relin_keys()
    plan = KeySwitchPlan(ctx, ctx.first_parms_id)
    n_ct = plan.n_ct_rns

    batch = 4
    a = np.stack([
        np.asarray(enc.encrypt(encoder.encode([0.5 * (i + 1), -i], 2.0 ** 25)).data)
        for i in range(batch)
    ])
    kdata = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
    want = np.asarray(jax.jit(build_ckks_mul_relin_rescale(ctx))(a, a, kdata))

    mesh = Mesh(np.asarray(devices[:4 * dp]).reshape(dp, 4),
                axis_names=("dp", "limb"))
    sh = NamedSharding(mesh, P("dp", None, "limb", None))
    out = np.asarray(ckks_mul_relin_rescale_limb_sharded(
        jax.device_put(a, sh), jax.device_put(a, sh), kdata, plan, mesh
    ))
    assert np.array_equal(out[..., : n_ct - 1, :], want)
    print(f"1) (dp={dp}, limb=4) explicit CKKS mul+relin+rescale: "
          f"batch {batch} bit-exact (1 all-gather + 1 tiny all-reduce)")

    # ---- 2) BFV BEHZ in five all-gathers -------------------------------
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(1024)
    parms.set_coeff_modulus(CoeffModulus.create(1024, [30] * 9))
    parms.set_plain_modulus(PlainModulus.batching(1024, 20).value)
    bctx = SealContext(parms, sec_level=SecLevelType.none)
    bkg = KeyGenerator(bctx)
    benc = Encryptor(bctx, public_key=bkg.public_key())
    brk = bkg.relin_keys()
    ba = np.asarray(benc.encrypt(Plaintext.from_hex("3x^2 + 2")).data)
    bb = np.asarray(benc.encrypt(Plaintext.from_hex("5x^1 + 7")).data)
    bk = np.stack([np.asarray(pk.data.data) for pk in brk.key(2)])
    bwant = np.asarray(jax.jit(build_bfv_mul_relin(bctx))(ba, bb, bk))

    lmesh = Mesh(np.asarray(devices[:4]), axis_names=("limb",))
    lsh = NamedSharding(lmesh, P(None, "limb", None))
    bout = np.asarray(bfv_mul_relin_limb_sharded(
        jax.device_put(ba, lsh), jax.device_put(bb, lsh), bk, bctx, lmesh
    ))
    assert np.array_equal(bout, bwant)
    print("2) BFV BEHZ multiply+relin on the five-gather schedule: bit-exact")

    # ---- 3) coefficient-sharded deep-N layout --------------------------
    cctx, ckg = ckks_ctx(4096, [30] * 8, nsp=1)
    cenc = Encryptor(cctx, public_key=ckg.public_key())
    cencoder = CKKSEncoder(cctx)
    crk = ckg.relin_keys()
    cplan = KeySwitchPlan(cctx, cctx.first_parms_id)
    ca = np.asarray(cenc.encrypt(cencoder.encode([0.5, -1.0], 2.0 ** 25)).data)
    ck = np.stack([np.asarray(pk.data.data) for pk in crk.key(2)])
    cwant = np.asarray(jax.jit(build_ckks_mul_relin_rescale(cctx))(ca, ca, ck))

    cmesh = Mesh(np.asarray(devices[:4]), axis_names=("coeff",))
    csh = NamedSharding(cmesh, P(None, None, "coeff"))
    cksh = NamedSharding(cmesh, P(None, None, None, "coeff"))
    cout = np.asarray(ckks_mul_relin_rescale_coeff_sharded(
        jax.device_put(ca, csh), jax.device_put(ca, csh),
        jax.device_put(ck, cksh), cplan, cmesh,
    ))
    assert np.array_equal(cout, cwant)
    print("3) coefficient-sharded (all_to_all-only) deep-N step: bit-exact")
    print("ex10 OK — three explicit multi-device schedules, all bit-exact "
          "vs in-core")


if __name__ == "__main__":
    main()
