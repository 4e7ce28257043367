"""Measure flat-hoisted vs BSGS encrypted matvec at large diagonal counts.

The flat hoisted matvec (build_ckks_matvec) pays one key-switch inner
product + digit Galois gather per diagonal; BSGS (build_ckks_matvec_bsgs)
pays ~2*sqrt(k) inner products but G extra mod-up/mod-down passes.  This
tool measures the crossover on the device (levers are measured, not
estimated).

Usage: python tools/bench_bsgs.py [--batch 16] [--dims 16,32,64] [--small]
One JSON line per (dim, variant).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gemini_seal import compile_cache  # noqa: E402

compile_cache.enable()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--dims", default="16,32,64")
    ap.add_argument("--small", action="store_true")
    cfg = ap.parse_args()

    import jax
    import numpy as np

    from gemini_seal import (CKKSEncoder, CoeffModulus,
                             EncryptionParameters, Encryptor,
                             KeyGenerator, SchemeType, SecLevelType,
                             SealContext)
    from gemini_seal.devices import time_calls
    from gemini_seal.models.pipelines import (build_ckks_matvec,
                                              build_ckks_matvec_bsgs)

    n = 1024 if cfg.small else 8192
    bits = [40, 30, 40] if cfg.small else [50, 40, 40, 50]
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, bits))
    parms.set_random_seed(tuple(range(8)))
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    tool = ctx.first_context_data().galois_tool
    slots = encoder.slot_count
    rng = np.random.default_rng(1)

    def rate(step, args, batch):
        return batch / time_calls(step, args)

    x = enc.encrypt(encoder.encode([0.5] * slots, 2.0 ** 40))
    a = np.broadcast_to(np.asarray(x.data), (cfg.batch,) + x.data.shape)
    da = jax.device_put(a)

    for dim in (int(d) for d in cfg.dims.split(",")):
        M = rng.uniform(-0.5, 0.5, size=(dim, dim))
        diagonals = {
            d: [M[i % dim, (i + d) % dim] for i in range(slots)]
            for d in range(dim)
        }

        flat_steps = sorted(s for s in diagonals if s != 0)
        flat_elts = [tool.get_elt_from_step(s) for s in flat_steps]
        gkf = kg.galois_keys(flat_elts)
        step = jax.jit(
            build_ckks_matvec(ctx, diagonals, 2.0 ** 40, encoder))
        dk = jax.device_put(gkf.stacked(*flat_elts))
        flat = rate(step, (da, dk), cfg.batch)
        print(json.dumps({"metric": f"matvec{dim}_flat_n{n}",
                          "value": round(flat, 2), "unit": "matvecs/s",
                          "rotations": len(flat_steps)}), flush=True)

        fn, rot_steps = build_ckks_matvec_bsgs(
            ctx, diagonals, 2.0 ** 40, encoder)
        elts = [tool.get_elt_from_step(s) for s in rot_steps]
        gkb = kg.galois_keys(elts)
        stepb = jax.jit(fn)
        dkb = jax.device_put(gkb.stacked(*elts))
        bsgs = rate(stepb, (da, dkb), cfg.batch)
        print(json.dumps({"metric": f"matvec{dim}_bsgs_n{n}",
                          "value": round(bsgs, 2), "unit": "matvecs/s",
                          "rotations": len(rot_steps),
                          "vs_flat": round(bsgs / flat, 3)}), flush=True)


if __name__ == "__main__":
    main()
