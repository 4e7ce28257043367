"""Diagnose the N=4096 bootstrap refresh error distribution on the device.

Rebuilds the EXACT bench_all.py bootstrap config (compiled programs come
from the persistent cache), runs ONE refresh, and prints slot-error
percentiles + the worst slots — discriminating a uniform noise floor
(all slots ~1e-1) from mod-raise overflow outliers (few huge slots).

Usage: python tools/bootstrap_diag.py [--n 4096] [--k-margin 0]
       [--bits 45] [--fbits 12] [--seed0 13]
"""

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gemini_seal import compile_cache  # noqa: E402

compile_cache.enable()

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--k-margin", type=int, default=0,
                    help="add to the default K (larger EvalMod window)")
    ap.add_argument("--bits", type=int, default=45)
    ap.add_argument("--fbits", type=int, default=None)
    ap.add_argument("--seed0", type=int, default=13)
    ap.add_argument("--cpu", action="store_true")
    cfg = ap.parse_args()
    if cfg.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    if cfg.cpu:
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
    from gemini_seal.models import bootstrap as bs

    n, radix, nsp = cfg.n, 4, 3
    K = max(12, int(math.ceil(4.5 * math.sqrt(n / 18.0)))) + cfg.k_margin
    bits, n_levels, _ = bs.plan_bootstrap_chain(
        n, radix=radix, K=K, scale_bits=cfg.bits, nsp=nsp, restored=2)
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, bits))
    parms.set_n_special_primes(nsp)
    parms.set_random_seed(tuple(range(8)))
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    t0 = time.time()
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    tool = ctx.first_context_data().galois_tool
    scale = 2.0 ** cfg.bits
    kwargs = {}
    if cfg.fbits is not None:
        kwargs["f_bits"] = cfg.fbits
    fn, out_pid, out_scale, rsteps, conj_elt = bs.build_ckks_bootstrap(
        ctx, scale, encoder, K=K, linear_mode="split", radix=radix, **kwargs)
    elts = [tool.get_elt_from_step(s_) for s_ in rsteps]
    gk = kg.galois_keys(elts + [conj_elt])
    print(f"keygen+build: {time.time()-t0:.0f}s, K={K}, "
          f"levels={n_levels}", flush=True)
    import jax as _j

    rot_stack = _j.device_put(gk.stacked(*elts))
    conj_stack = _j.device_put(gk.stacked(conj_elt))
    rks = _j.device_put(kg.relin_keys().stacked(2))
    ev = Evaluator(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    rng = np.random.default_rng(cfg.seed0)
    msg = rng.uniform(-1, 1, encoder.slot_count)
    ct = enc.encrypt(encoder.encode(msg.tolist(), scale))
    while ctx.get_context_data(ct.parms_id).next_context_data is not None:
        ct = ev.mod_switch_to_next(ct)
    da = _j.device_put(np.asarray(ct.data))
    t0 = time.time()
    out0 = np.asarray(fn(da, rot_stack, conj_stack, rks))
    print(f"refresh: {time.time()-t0:.0f}s", flush=True)
    got = np.asarray(encoder.decode(dec.decrypt(
        Ciphertext(out0, out_pid, True, out_scale)), as_complex=True))
    err = np.abs(got[: encoder.slot_count] - msg)
    pct = {p: float(np.percentile(err, p)) for p in (50, 90, 99, 99.9, 100)}
    worst = np.argsort(err)[-8:][::-1]
    print(json.dumps({
        "n": n, "K": K, "bits": cfg.bits, "percentiles": pct,
        "n_slots_above_1e-3": int((err > 1e-3).sum()),
        "n_slots_above_1e-2": int((err > 1e-2).sum()),
        "worst_slots": [[int(i), float(err[i])] for i in worst],
    }), flush=True)


if __name__ == "__main__":
    main()
