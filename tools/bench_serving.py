"""Wire-to-wire serving benchmark: submit() vs the pipelined
submit_stream() (overlapping host work and host<->device copies
with compute), and expanded vs seed-compressed ingress blobs.

Shape mirrors PERF.md's serving row: fused dense layer act(M@x+b),
8x8 at N=8192, compiled batch 16, SEAL wire blobs in/out.

Usage: python tools/bench_serving.py [--batches 24] [--batch 16]
Prints one JSON line per metric.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gemini_seal import compile_cache  # noqa: E402

compile_cache.enable()

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=24)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--small", action="store_true")
    cfg = ap.parse_args()

    if cfg.small:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from gemini_seal import (
        CKKSEncoder, CoeffModulus, EncryptionParameters, Encryptor,
        KeyGenerator, SchemeType, SecLevelType, SealContext,
    )
    from gemini_seal import serialization as ser
    from gemini_seal.models.pipelines import build_ckks_dense_layer
    from gemini_seal.models.serving import EncryptedComputeServer

    n = 512 if cfg.small else 8192
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [50, 40, 40, 50]))
    parms.set_random_seed(tuple(range(31, 39)))
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key(), secret_key=kg.secret_key)
    encoder = CKKSEncoder(ctx)
    tool = ctx.first_context_data().galois_tool
    rk = kg.relin_keys()
    scale = 2.0 ** 40
    dim = 8

    rng = np.random.default_rng(3)
    M = rng.uniform(-0.5, 0.5, size=(dim, dim))
    b = rng.uniform(-0.2, 0.2, size=dim)
    slots = encoder.slot_count
    diagonals = {
        d: [M[i % dim, (i + d) % dim] for i in range(slots)]
        for d in range(dim)
    }
    bias = [b[i % dim] for i in range(slots)]
    steps = sorted(s for s in diagonals if s != 0)
    elts = [tool.get_elt_from_step(s) for s in steps]
    gk = kg.galois_keys(elts)
    layer, out_id, out_scale = build_ckks_dense_layer(
        ctx, diagonals, bias, scale, encoder)
    server = EncryptedComputeServer(
        ctx, layer, [gk.stacked(*elts), rk.stacked(2)],
        out_parms_id=out_id, out_is_ntt=True, out_scale=out_scale,
        batch_size=cfg.batch)

    def make_blobs(seeded):
        out = []
        for _ in range(cfg.batch):
            x = rng.uniform(-1, 1, size=dim)
            pt = encoder.encode([x[i % dim] for i in range(slots)], scale)
            if seeded:
                out.append(enc.encrypt_symmetric_serializable(pt).save())
            else:
                out.append(ser.save(enc.encrypt(pt)))
        return out

    work = [make_blobs(False) for _ in range(cfg.batches)]
    server.warm(work[0][0])

    t0 = time.perf_counter()
    for bl in work:
        server.submit(bl)
    t_seq = time.perf_counter() - t0
    reqs = cfg.batches * cfg.batch
    print(json.dumps({"metric": "serving_wire_to_wire_req_per_s",
                      "value": round(reqs / t_seq, 2), "unit": "req/s"}),
          flush=True)

    t0 = time.perf_counter()
    for _ in server.submit_stream(work):
        pass
    t_pipe = time.perf_counter() - t0
    print(json.dumps({"metric": "serving_wire_to_wire_pipelined_req_per_s",
                      "value": round(reqs / t_pipe, 2), "unit": "req/s",
                      "vs_unpipelined": round(t_seq / t_pipe, 3)}),
          flush=True)

    work_seeded = [make_blobs(True) for _ in range(cfg.batches)]
    sz_full = sum(len(b) for b in work[0])
    sz_seed = sum(len(b) for b in work_seeded[0])
    t0 = time.perf_counter()
    for _ in server.submit_stream(work_seeded):
        pass
    t_seeded = time.perf_counter() - t0
    print(json.dumps({"metric": "serving_seeded_pipelined_req_per_s",
                      "value": round(reqs / t_seeded, 2), "unit": "req/s",
                      "ingress_bytes_ratio": round(sz_seed / sz_full, 3)}),
          flush=True)


if __name__ == "__main__":
    main()
