"""Sweep the NTT's fused-stage depth k (ops/ntt.py FUSE_STAGES) on one GPU.

k butterfly stages run per materialization in one radix-2^k view of the
same radix-2 arithmetic, so every k gives bit-identical outputs; this
measures which k the compiled program runs fastest at.  Prints poly-limb
NTTs/s for k = 1..4, forward and inverse, at N=16384 L=6 and N=8192 L=4,
then the bench.py headline step (CKKS N=8192 multiply+relinearize+rescale)
at each k.  Every timed call ends in ``block_until_ready`` on its real
output; every output is checked against k=1 before it is timed.

    python tools/bench_ntt_fused.py [--batch 128] [--skip-headline]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEPTHS = (1, 2, 3, 4)
SHAPES = ((16384, [50, 40, 40, 40, 40, 50]), (8192, [50, 40, 40, 50]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--skip-headline", action="store_true")
    cfg = ap.parse_args()

    import jax
    import numpy as np

    from gemini_seal import compile_cache
    from gemini_seal.devices import card_line, require_gpu, time_calls
    from gemini_seal.modulus import CoeffModulus
    from gemini_seal.ops import ntt

    require_gpu(jax.default_backend(), "bench_ntt_fused.py")
    compile_cache.enable()
    print(f"card: {card_line()}; {jax.devices()[0].device_kind}", flush=True)
    default = ntt.FUSE_STAGES

    def emit(**rec):
        print(json.dumps(rec), flush=True)

    try:
        for n, bits in SHAPES:
            mods = CoeffModulus.create(n, bits)
            tabs = ntt.build_ntt_tables(n.bit_length() - 1, mods)
            rng = np.random.default_rng(0)
            x = np.stack(
                [rng.integers(0, m.value, (cfg.batch, 2, n), dtype=np.uint64)
                 for m in mods], axis=2,
            )  # [B, 2, L, N]
            dx = jax.device_put(x)
            rows = cfg.batch * 2 * len(mods)
            want = {}
            for depth in DEPTHS:
                ntt.FUSE_STAGES = depth
                for kind, fn in (("fwd", ntt.ntt_forward),
                                 ("inv", ntt.ntt_inverse)):
                    step = jax.jit(lambda v, f=fn: f(v, tabs))
                    got = np.asarray(step(dx))
                    want.setdefault(kind, got)
                    if not np.array_equal(got, want[kind]):
                        raise AssertionError(f"N={n} k={depth} {kind} differs")
                    emit(n=n, limbs=len(mods), batch=cfg.batch, k=depth,
                         kind=kind, ntts_per_s=rows / time_calls(step, (dx,)))

        if cfg.skip_headline:
            return

        from gemini_seal import (
            CKKSEncoder, EncryptionParameters, Encryptor, KeyGenerator,
            SchemeType, SealContext,
        )
        from gemini_seal.models.pipelines import build_ckks_mul_relin_rescale

        parms = EncryptionParameters(SchemeType.CKKS)
        parms.set_poly_modulus_degree(8192)
        parms.set_coeff_modulus(CoeffModulus.create(8192, [50, 40, 40, 50]))
        parms.set_random_seed(tuple(range(71, 79)))
        ctx = SealContext(parms)
        kg = KeyGenerator(ctx)
        enc = Encryptor(ctx, public_key=kg.public_key())
        encoder = CKKSEncoder(ctx)
        ct = enc.encrypt(encoder.encode([1.001] * encoder.slot_count,
                                        2.0 ** 40))
        dev_a = jax.device_put(np.broadcast_to(
            np.asarray(ct.data), (cfg.batch,) + ct.data.shape))
        dev_rk = jax.device_put(kg.relin_keys().stacked(2))
        for depth in DEPTHS:
            ntt.FUSE_STAGES = depth
            step = jax.jit(build_ckks_mul_relin_rescale(ctx, fused=True))
            per = time_calls(step, (dev_a, dev_a, dev_rk), min_seconds=3.0)
            emit(step="ckks_mul_relin_rescale_n8192", batch=cfg.batch,
                 k=depth, ops_per_s=cfg.batch / per)
    finally:
        ntt.FUSE_STAGES = default


if __name__ == "__main__":
    main()
