"""Bootstrap refresh precision sweep.

Runs the FULL composed refresh (split + cosine EvalMod) at a non-toy
shape over (r double-angle count, scaling prime width) and prints one
JSON line per cell: the Chebyshev degree plan_evalmod picked, the levels
consumed/restored, and the measured max slot error of decrypt(refresh)
vs the original message.  Backs the PERF.md error table.

Usage:
    python tools/bootstrap_precision.py [--n 1024] [--radix 4]
        [--r auto,3,4] [--bits 40,45]
CPU is fine (the per-level jitted engine keeps compiles small); the
persistent JAX cache makes repeats cheap.
"""

import argparse
import json
import math
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gemini_seal import compile_cache  # noqa: E402

compile_cache.enable()

import numpy as np


def run_cell(n, radix, r, bits, nsp=2):
    import jax

    jax.config.update("jax_platforms", "cpu")
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
    from gemini_seal.models.bootstrap import (
        build_ckks_bootstrap,
        plan_bootstrap_chain,
    )
    from gemini_seal.models.evalmod import plan_evalmod

    K = max(12, int(math.ceil(4.5 * math.sqrt(n / 18.0))))
    r_used, coeffs, em_depth = plan_evalmod(K, r)
    mod_bits, n_levels, _ = plan_bootstrap_chain(
        n, radix=radix, K=K, r=r, scale_bits=bits, nsp=nsp, restored=2)
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, mod_bits))
    parms.set_n_special_primes(nsp)
    parms.set_random_seed(tuple(range(1, 9)))
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    ev = Evaluator(ctx)
    tool = ctx.first_context_data().galois_tool
    scale = float(2.0 ** bits)

    fn, out_pid, out_scale, rot_steps, conj_elt = build_ckks_bootstrap(
        ctx, scale, encoder, r=r, linear_mode="split", radix=radix)
    elts = [tool.get_elt_from_step(s) for s in rot_steps]
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
    out = np.asarray(fn(np.asarray(ct.data), rot_stack, conj_stack, rks))
    got = np.asarray(encoder.decode(
        dec.decrypt(Ciphertext(out, out_pid, True, out_scale)),
        as_complex=True))[:s]
    err = float(np.abs(got - msg).max())
    L_out = len(ctx.get_context_data(out_pid).parms.coeff_modulus)
    return {
        "n": n, "radix": radix, "r": r_used, "cheb_degree": len(coeffs) - 1,
        "prime_bits": bits, "K": K, "levels_consumed": n_levels,
        "levels_restored": L_out, "max_err": err,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--radix", type=int, default=4)
    ap.add_argument("--r", default="auto,3,4")
    ap.add_argument("--bits", default="40,45")
    cfg = ap.parse_args()
    rs = [None if x == "auto" else int(x) for x in cfg.r.split(",")]
    for bits in [int(x) for x in cfg.bits.split(",")]:
        for r in rs:
            rec = run_cell(cfg.n, cfg.radix, r, bits)
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
