"""Example 8: device-speed serving (no reference analogue).

Shows the three execution tiers on the same computation
(square + relinearize + rescale + rotate on CKKS data):

1. the exact host plane (`Evaluator`, numpy) — correctness work;
2. `DeviceEvaluator` — the same per-op API, each op one cached compiled
   program, ciphertexts resident on the device;
3. a fused `models.pipelines` step — the whole circuit as one program,
   batched over many ciphertexts (the production path; see PERF.md).

Usage: python ex8_device_serving.py [--n 4096] [--batch 8]
"""

import argparse
import time

import numpy as np

from common import print_parameters

from gemini_seal import (
    CKKSEncoder,
    CoeffModulus,
    Decryptor,
    DeviceEvaluator,
    EncryptionParameters,
    Encryptor,
    Evaluator,
    KeyGenerator,
    SchemeType,
    SecLevelType,
    SealContext,
)
from gemini_seal.models.pipelines import build_ckks_train_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args()

    import jax

    n = args.n
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [50, 40, 40, 50]))
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    print_parameters(ctx)

    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    dec = Decryptor(ctx, kg.secret_key)
    encoder = CKKSEncoder(ctx)
    tool = ctx.first_context_data().galois_tool
    elt = tool.get_elt_from_step(1)
    rk = kg.relin_keys()
    gk = kg.galois_keys([elt])

    scale = 2.0 ** 40
    vals = [0.5, -1.25, 2.0, 3.5]
    ct = enc.encrypt(encoder.encode(vals, scale))

    # --- tier 1: host plane ------------------------------------------------
    ev = Evaluator(ctx)
    t0 = time.perf_counter()
    prod = ev.rescale_to_next(ev.relinearize(ev.multiply(ct, ct), rk))
    rot = ev.rotate_vector(prod, 1, gk)
    host_out = ev.add(prod, rot)
    t_host = time.perf_counter() - t0
    print(f"host Evaluator: {t_host*1e3:8.1f} ms  (exact numpy)")

    # --- tier 2: DeviceEvaluator -------------------------------------------
    dev = DeviceEvaluator(ctx)
    dct = dev.put(ct)
    # first pass compiles; second pass is the serving cost
    for label in ("compile", "serve  "):
        t0 = time.perf_counter()
        dprod = dev.rescale_to_next(dev.relinearize(dev.multiply(dct, dct), rk))
        drot = dev.rotate_vector(dprod, 1, gk)
        dev_out = dev.add(dprod, drot)
        np.asarray(dev_out.data)  # sync
        print(f"DeviceEvaluator ({label}): {(time.perf_counter()-t0)*1e3:8.1f} ms")
    np.testing.assert_array_equal(np.asarray(dev_out.data), np.asarray(host_out.data))
    print("DeviceEvaluator result bit-exact vs host plane")

    # --- tier 3: fused batched pipeline --------------------------------------
    step = jax.jit(build_ckks_train_step(ctx, rotate_steps=1))
    rk_data = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
    gk_data = np.stack([np.asarray(pk.data.data) for pk in gk.key(elt)])
    batch = np.broadcast_to(np.asarray(ct.data), (args.batch,) + ct.data.shape)
    out = step(batch, batch, rk_data, gk_data)
    np.asarray(out)  # compile + sync
    t0 = time.perf_counter()
    out = step(batch, batch, rk_data, gk_data)
    np.asarray(out)
    t_fused = time.perf_counter() - t0
    print(f"fused pipeline: {t_fused*1e3:8.1f} ms for batch {args.batch} "
          f"({t_fused/args.batch*1e3:.2f} ms/ciphertext)")
    np.testing.assert_array_equal(np.asarray(out[0]), np.asarray(host_out.data))
    print("fused pipeline bit-exact vs host plane")

    got = encoder.decode(dec.decrypt(host_out))
    sq = [v * v for v in vals]
    expect = [sq[i] + (sq[i + 1] if i + 1 < len(vals) else 0.0)
              for i in range(len(vals))]
    assert all(abs(g - e) < 1e-3 for g, e in zip(got[: len(vals)], expect))
    print("decrypted result correct; ex8 OK")


if __name__ == "__main__":
    main()
