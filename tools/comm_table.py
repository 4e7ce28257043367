"""Emit the collective-volume table of the sharded pipelines.

A byte-count model extracted from the GSPMD-partitioned HLO: for each
sharded pipeline we report the per-step collective traffic (result bytes
per device, by collective kind) next to the step's input working-set
bytes.  The counts are properties of the compiled program, so a virtual
CPU mesh gives the same table as the cards.

Usage: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       python tools/comm_table.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from gemini_seal import compile_cache

jax.config.update("jax_platforms", "cpu")
compile_cache.enable()

import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from gemini_seal import (
    CKKSEncoder, CoeffModulus, EncryptionParameters, Encryptor, KeyGenerator,
    SchemeType, SecLevelType, SealContext,
)
from gemini_seal.models.pipelines import (
    build_ckks_mul_relin_rescale, build_ckks_train_step,
)
from gemini_seal.parallel.comm import collective_stats
from gemini_seal.parallel.mesh import make_he_mesh


def make_ctx(n, n_primes, nsp):
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [30] * n_primes))
    parms.set_n_special_primes(nsp)
    parms.set_random_seed(tuple(range(21, 29)))
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    return ctx, KeyGenerator(ctx)


def row(name, ctx, kg, batch, dp, limb, builder, n_keys=1):
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    rk = kg.relin_keys()
    ct = enc.encrypt(encoder.encode([0.5], 2.0 ** 25))
    a = np.stack([np.asarray(ct.data)] * batch)
    rk_data = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])

    mesh = make_he_mesh(n_devices=dp * limb, dp=dp, limb=limb)
    ct_sh = NamedSharding(mesh, P("dp" if dp > 1 else None, None, "limb", None))
    key_sh = NamedSharding(mesh, P())

    args = [jax.device_put(a, ct_sh), jax.device_put(a, ct_sh),
            jax.device_put(rk_data, key_sh)]
    if n_keys == 2:
        tool = ctx.first_context_data().galois_tool
        gk = kg.galois_keys([tool.get_elt_from_step(1)])
        gk_data = np.stack(
            [np.asarray(pk.data.data) for pk in gk.key(tool.get_elt_from_step(1))]
        )
        args.append(jax.device_put(gk_data, key_sh))

    step = jax.jit(builder(ctx), in_shardings=tuple(
        [ct_sh, ct_sh] + [key_sh] * n_keys))
    stats = collective_stats(step.lower(*args).compile().as_text())

    hbm = a.nbytes * 2 + rk_data.nbytes  # inputs' working set per step
    kinds = ", ".join(
        f"{k}:{stats.bytes[k]//1024}K" for k in sorted(stats.count)
    ) or "none"
    print(f"| {name} | ({dp},{limb}) | {a.shape} | {stats.total_bytes/1024:.0f} KiB "
          f"| {hbm/1024:.0f} KiB | {stats.total_bytes/max(hbm,1):.2f} | {kinds} |")


def main():
    print("| pipeline | mesh (dp,limb) | ct shape | collective bytes/step | "
          "working set | collective:working set | by kind |")
    print("|---|---|---|---|---|---|---|")

    # realistic serving shape: N=4096, L=8 + nsp=2
    ctx, kg = make_ctx(4096, 10, 2)
    row("mul+relin+rescale", ctx, kg, 8, 2, 4,
        lambda c: build_ckks_mul_relin_rescale(c))
    row("mul+relin+rescale (fused)", ctx, kg, 8, 2, 4,
        lambda c: build_ckks_mul_relin_rescale(c, fused=True))
    row("mul+relin+rescale", ctx, kg, 8, 1, 8,
        lambda c: build_ckks_mul_relin_rescale(c))
    row("mul+relin+rescale", ctx, kg, 8, 8, 1,
        lambda c: build_ckks_mul_relin_rescale(c))
    row("train step (mul+rot+add)", ctx, kg, 8, 2, 4,
        lambda c: build_ckks_train_step(c), n_keys=2)

    # explicit round-3 schedules (hand-placed collectives)
    _explicit_rows(ctx, kg)


def _explicit_rows(ctx, kg):
    from jax.sharding import Mesh

    from gemini_seal.models.pipelines import build_bfv_mul_relin
    from gemini_seal.ops.keyswitch import KeySwitchPlan
    from gemini_seal.parallel.behz_sp import bfv_mul_relin_limb_sharded
    from gemini_seal.parallel.keyswitch_sp import (
        ckks_mul_relin_rescale_limb_sharded,
    )
    from gemini_seal.parallel.pipeline_csp import (
        ckks_mul_relin_rescale_coeff_sharded,
    )

    devices = jax.devices()
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    rk = kg.relin_keys()
    plan = KeySwitchPlan(ctx, ctx.first_parms_id)
    a = np.stack([np.asarray(
        enc.encrypt(encoder.encode([0.5], 2.0 ** 25)).data)] * 8)
    kdata = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
    hbm = a.nbytes * 2 + kdata.nbytes

    def emit(name, mesh_desc, stats):
        kinds = ", ".join(
            f"{k}:{stats.bytes[k]//1024}K" for k in sorted(stats.count)
        ) or "none"
        print(f"| {name} | {mesh_desc} | {a.shape} | "
              f"{stats.total_bytes/1024:.0f} KiB | {hbm/1024:.0f} KiB | "
              f"{stats.total_bytes/max(hbm,1):.2f} | {kinds} |")

    # explicit one-gather limb schedule under (dp=2, limb=4)
    mesh = Mesh(np.asarray(devices[:8]).reshape(2, 4), ("dp", "limb"))
    sh = NamedSharding(mesh, P("dp", None, "limb", None))
    da = jax.device_put(a, sh)
    fn = jax.jit(
        lambda x, y: ckks_mul_relin_rescale_limb_sharded(x, y, kdata, plan, mesh),
        in_shardings=(sh, sh),
    )
    emit("mul+relin+rescale EXPLICIT", "(2,4)",
         collective_stats(fn.lower(da, da).compile().as_text()))

    # coefficient-sharded all_to_all schedule
    cmesh = Mesh(np.asarray(devices[:4]), ("coeff",))
    csh = NamedSharding(cmesh, P(None, None, None, "coeff"))
    cksh = NamedSharding(cmesh, P(None, None, None, "coeff"))
    dca = jax.device_put(a, csh)
    dck = jax.device_put(kdata, cksh)
    cfn = jax.jit(
        lambda x, y, k: ckks_mul_relin_rescale_coeff_sharded(x, y, k, plan, cmesh),
        in_shardings=(csh, csh, cksh),
    )
    emit("mul+relin+rescale COEFF-SHARDED", "(coeff=4)",
         collective_stats(cfn.lower(dca, dca, dck).compile().as_text()))

    # BFV BEHZ: GSPMD vs the explicit five-gather schedule
    from gemini_seal import PlainModulus, Plaintext

    bparms = EncryptionParameters(SchemeType.BFV)
    bparms.set_poly_modulus_degree(2048)
    bparms.set_coeff_modulus(CoeffModulus.create(2048, [30] * 9))
    bparms.set_plain_modulus(PlainModulus.batching(2048, 20).value)
    bparms.set_random_seed(tuple(range(21, 29)))
    bctx = SealContext(bparms, sec_level=SecLevelType.none)
    bkg = KeyGenerator(bctx)
    benc = Encryptor(bctx, public_key=bkg.public_key())
    brk = bkg.relin_keys()
    ba = np.stack([np.asarray(
        benc.encrypt(Plaintext.from_hex("3x^2 + 2")).data)] * 8)
    bk = np.stack([np.asarray(pk.data.data) for pk in brk.key(2)])
    lmesh = Mesh(np.asarray(devices[:4]), ("limb",))
    lsh = NamedSharding(lmesh, P(None, None, "limb", None))
    dba = jax.device_put(ba, lsh)
    hbm_b = ba.nbytes * 2 + bk.nbytes

    def emit_b(name, stats):
        kinds = ", ".join(
            f"{k}:{stats.bytes[k]//1024}K" for k in sorted(stats.count)
        ) or "none"
        print(f"| {name} | (limb=4) | {ba.shape} | "
              f"{stats.total_bytes/1024:.0f} KiB | {hbm_b/1024:.0f} KiB | "
              f"{stats.total_bytes/max(hbm_b,1):.2f} | {kinds} |")

    gfn = jax.jit(build_bfv_mul_relin(bctx), in_shardings=(lsh, lsh, None))
    emit_b("BFV BEHZ mul+relin GSPMD",
           collective_stats(gfn.lower(dba, dba, bk).compile().as_text()))
    efn = jax.jit(
        lambda x, y: bfv_mul_relin_limb_sharded(x, y, bk, bctx, lmesh),
        in_shardings=(lsh, lsh),
    )
    emit_b("BFV BEHZ mul+relin EXPLICIT",
           collective_stats(efn.lower(dba, dba).compile().as_text()))


if __name__ == "__main__":
    main()
