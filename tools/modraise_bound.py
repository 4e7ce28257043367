"""Exact mod-raise residual measurement (round-5 bootstrap precision bug).

The bootstrap's EvalMod window K must bound ||I||_inf where
c0 + c1*s = (m + e) + q0*I over Z[X]/(X^N+1) for an exhausted (level-0)
ciphertext.  The shipped empirical formula K = 4.5*sqrt(N/18) ~ 1.06
sqrt(N) is ~3.7 sigma of the residual (sigma ~ sqrt(N/12) for the dense
ternary secret), which fails with near-certainty once N has thousands of
coefficients — the round-5 N=4096 bench measured max_err 0.146 from
exactly these overflows.  This tool computes I EXACTLY (Python-int
negacyclic convolution, no device, no approximation) over many fresh
ciphertexts to calibrate the replacement formula.

Usage: python tools/modraise_bound.py [--n 4096] [--trials 5]
"""

import argparse
import math
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gemini_seal import compile_cache  # noqa: E402

compile_cache.enable()

import numpy as np


def residual_max(n, seed):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from gemini_seal import (
        CKKSEncoder,
        CoeffModulus,
        EncryptionParameters,
        Encryptor,
        Evaluator,
        KeyGenerator,
        SchemeType,
        SealContext,
        SecLevelType,
    )
    from gemini_seal.ops.ntt import ntt_inverse

    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [59, 45, 59]))
    parms.set_random_seed(tuple(seed))
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    ev = Evaluator(ctx)
    rng = np.random.default_rng(seed[0])
    msg = rng.uniform(-1, 1, encoder.slot_count)
    ct = enc.encrypt(encoder.encode(msg.tolist(), 2.0 ** 45))
    while ctx.get_context_data(ct.parms_id).next_context_data is not None:
        ct = ev.mod_switch_to_next(ct)
    cd = ctx.get_context_data(ct.parms_id)
    q0 = cd.parms.coeff_modulus[0].value

    # coefficient-domain c0, c1 and the ternary secret (q0 row)
    c = np.asarray(ntt_inverse(np.asarray(ct.data), cd.ntt_tables))
    c0 = c[0, 0].astype(object)
    c1 = c[1, 0].astype(object)
    key_cd = ctx.key_context_data()
    sk = np.asarray(kg.secret_key.data.data)
    s_row = np.asarray(ntt_inverse(sk[0:1, :], cd.ntt_tables))[0]
    s = np.where(s_row > q0 // 2, s_row.astype(object) - q0,
                 s_row.astype(object))
    assert set(np.unique(s.astype(np.int64))) <= {-1, 0, 1}

    def center(x):
        x = x % q0
        return np.where(x > q0 // 2, x - q0, x)

    c0c = center(c0)
    c1c = center(c1)
    # negacyclic c1*s: s is ternary, so the product is a signed sum of
    # negacyclic rotations of c1
    acc = np.zeros(n, dtype=object)
    for k in np.nonzero(s)[0]:
        rolled = np.roll(c1c, int(k))
        rolled[: int(k)] = -rolled[: int(k)]      # X^N = -1 wraparound
        acc = acc + int(s[k]) * rolled
    total = c0c + acc
    me = center(total)
    I = (total - me)
    assert (I % q0 == 0).all()
    I = I // q0
    return int(max(-I.min(), I.max())), float(np.sqrt(np.mean((I * I).astype(float))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--trials", type=int, default=5)
    cfg = ap.parse_args()
    n = cfg.n
    k_old = max(12, int(math.ceil(4.5 * math.sqrt(n / 18.0))))
    maxes = []
    for t in range(cfg.trials):
        mx, rms = residual_max(n, list(range(10 * t + 1, 10 * t + 9)))
        maxes.append(mx)
        print(f"N={n} trial {t}: max|I| = {mx}, rms = {rms:.2f} "
              f"(old K = {k_old})", flush=True)
    print(f"N={n}: max over {cfg.trials} trials = {max(maxes)}; "
          f"sigma-model sqrt(N/12) = {math.sqrt(n / 12):.1f}")


if __name__ == "__main__":
    main()
