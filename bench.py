"""Benchmark: CKKS multiply+relinearize+rescale throughput on one GPU.

BASELINE config 4's hot op, as the reference's own performance example
measures it (native/examples/7_performance.cpp: per-op wall clock averaged
over iterations): ciphertext multiply + relinearize + rescale at N=8192,
CKKS {50,40,40,50}, 128-bit security, scale 2^40, with the fused P*q_last
mod-down (``build_ckks_mul_relin_rescale(fused=True)``), over a
device-resident ciphertext batch.  Each timed call ends in
``block_until_ready`` on the step's real output.

    python bench.py                         # one JSON line, default batch
    python bench.py --batch 32,128,1024     # one JSON line per batch
    python bench.py --trace DIR             # also a profile of 3 steps

It refuses to run without a GPU.  Before the JSON lines it prints the card
(name and power limit, as nvidia-smi gives them).
"""

import argparse
import json
import sys

DEFAULT_BATCH = 64  # the best of a 32..1024 sweep on an H100 (PERF.md)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", default=str(DEFAULT_BATCH),
                    help="ciphertext batch, or a comma list to sweep")
    ap.add_argument("--trace", default="",
                    help="write a jax.profiler trace (with a Perfetto "
                         "JSON) of 3 steps at the first batch to this "
                         "directory")
    cfg = ap.parse_args(argv)
    batches = [int(b) for b in cfg.batch.split(",")]

    import jax
    import numpy as np

    from gemini_seal import (
        CKKSEncoder, CoeffModulus, EncryptionParameters, Encryptor,
        KeyGenerator, SchemeType, SealContext, compile_cache,
    )
    from gemini_seal.devices import (
        card_line, device_record, require_gpu, time_calls,
    )
    from gemini_seal.models.pipelines import build_ckks_mul_relin_rescale

    require_gpu(jax.default_backend(), "bench.py")
    compile_cache.enable()
    print(f"card: {card_line()}", flush=True)
    device = device_record(jax.devices()[:1])

    n = 8192
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [50, 40, 40, 50]))
    parms.set_random_seed(tuple(range(71, 79)))
    ctx = SealContext(parms)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    ct = enc.encrypt(encoder.encode([1.001] * encoder.slot_count, 2.0 ** 40))
    dev_rk = jax.device_put(kg.relin_keys().stacked(2))

    # fused=True merges the rescale into the key-switch mod-down: decrypts
    # equal to the sequential path, not bit-identical (one rounding by
    # P*q_last; test_pipelines.test_fused_rescale_decrypts_equal)
    step = jax.jit(build_ckks_mul_relin_rescale(ctx, fused=True))
    for batch in batches:
        dev_a = jax.device_put(
            np.broadcast_to(np.asarray(ct.data), (batch,) + ct.data.shape))
        per = time_calls(step, (dev_a, dev_a, dev_rk), min_seconds=3.0)
        print(json.dumps({
            "metric": "ckks_mul_relin_rescale_n8192_ops_per_s",
            "value": batch / per,
            "unit": "ciphertext_ops/s",
            "batch": batch,
            "device": device,
        }), flush=True)
        if cfg.trace and batch == batches[0]:
            with jax.profiler.trace(cfg.trace, create_perfetto_trace=True):
                for _ in range(3):
                    out = step(dev_a, dev_a, dev_rk)
                jax.block_until_ready(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
