"""Per-config floor accounting.

For each BASELINE config this traces the EXACT pipeline bench_all.py times
(same shapes, same builders) with the trace-time counters in
ops/ntt.TRACE_COUNTS and ops/modops.TRACE_MACS enabled, giving the true
per-op work profile of the compiled program:

- poly-limb NTT rows per ciphertext op, split forward/inverse, and
- 64x64->128 MAC element counts per op (the key-switch inner product /
  BEHZ base-conversion contractions — the second-largest term).

With ``--measure`` it also times the NTT rows/s per N and the MAC rate on
the GPU it runs on and prints the modeled floor

    t_floor = fwd_rows / rate_fwd(N) + inv_rows / rate_inv(N)
              + macs / rate_mac

Everything else (dyadic products, Galois gathers, where-chains, reshapes)
is deliberately UNMODELED — XLA fuses most of it into the NTT/MAC loads —
so a measured step close to its floor is NTT+contraction bound; one far
from it spends real time elsewhere, worth profiling.  No rates are kept
in the code: a floor is printed only from rates measured in the same run.

Usage:
    python tools/floor_model.py            # work profile per op (CPU ok)
    python tools/floor_model.py --measure  # + rates and floor, on a GPU
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BATCH = 128


def _emit_rates():
    """Measure NTT rows/s per N and the MAC rate on the GPU."""
    import jax
    import numpy as np

    from gemini_seal.devices import card_line, time_calls
    from gemini_seal.modulus import CoeffModulus
    from gemini_seal.ops import modops, ntt
    from gemini_seal.ops.dyadic import LimbConstants

    print(f"card: {card_line()}; {jax.devices()[0].device_kind}", flush=True)
    out = {"ntt": {}}
    rng = np.random.default_rng(0)
    for n, bits in [(4096, [36, 36, 37]), (8192, [50, 40, 40, 50]),
                    (16384, [50, 40, 40, 40, 40, 50]),
                    (32768, [59, 40, 40, 40, 40, 40, 40, 59])]:
        logn = n.bit_length() - 1
        mods = CoeffModulus.create(n, bits)
        L = len(mods)
        tabs = ntt.build_ntt_tables(logn, mods)
        # batch 128 lanes at EVERY N (the config benches run batch-128
        # ciphertexts; shrinking b with N under-amortizes the big-N rows
        # and under-states the floor)
        b = BATCH
        x = np.stack(
            [rng.integers(0, m.value, (b, 2, n), dtype=np.uint64) for m in mods],
            axis=2)
        dx = jax.device_put(x)
        rows = b * 2 * L
        fwd = rows / time_calls(jax.jit(lambda y: ntt.ntt_forward(y, tabs)),
                                (dx,))
        inv = rows / time_calls(jax.jit(lambda y: ntt.ntt_inverse(y, tabs)),
                                (dx,))
        out["ntt"][n] = (fwd, inv)
        print(f"  N={n}: fwd {fwd:,.0f} rows/s, inv {inv:,.0f} rows/s",
              flush=True)

    # MAC rate at a key-switch-shaped contraction: [B, nb, O, N] x [O, nb]
    n, nb, O, b = 8192, 2, 6, 32
    mods = CoeffModulus.create(n, [50, 40, 40, 40, 50, 59])
    lc = LimbConstants.from_moduli(mods[:O])
    a = rng.integers(0, 1 << 50, (b, nb, O, n), dtype=np.uint64)
    w = rng.integers(0, 1 << 50, (O, nb), dtype=np.uint64)
    da, dw = jax.device_put(a), jax.device_put(w)

    def contract(x, k):
        return modops.accumulate_mulmod_128(
            ((x[:, i], k[:, i, None]) for i in range(nb)),
            lc.p, lc.ratio0, lc.ratio1)

    macs = b * nb * O * n
    rate = macs / time_calls(jax.jit(contract), (da, dw))
    out["mac_g"] = rate
    print(f"  MAC rate: {rate / 1e9:.3f} G MAC/s", flush=True)
    return out


def _trace(fn, *args):
    """eval_shape fn(*args) with the counters on; return per-trace totals."""
    import jax

    from gemini_seal.ops import modops, ntt

    ntt.TRACE_COUNTS = []
    modops.TRACE_MACS = []
    try:
        jax.eval_shape(fn, *args)
        counts = {}
        for kind, rows, n in ntt.TRACE_COUNTS:
            counts[(kind, n)] = counts.get((kind, n), 0) + rows
        macs = sum(modops.TRACE_MACS)
    finally:
        ntt.TRACE_COUNTS = None
        modops.TRACE_MACS = None
    return counts, macs


def trace_configs(keys):
    """Build each bench_all config's pipeline and trace its work profile.

    Returns {key: {"n": N, "ops": ops/call, "fwd": rows, "inv": rows,
    "macs": elements}} — rows/macs are per CALL; divide by "ops" for
    per-ciphertext-op numbers.
    """
    import numpy as np

    from gemini_seal import (
        BatchEncoder, CKKSEncoder, CoeffModulus, EncryptionParameters,
        Encryptor, KeyGenerator, PlainModulus, SchemeType, SecLevelType,
        SealContext,
    )
    from gemini_seal.models.pipelines import (
        build_bfv_mul_relin, build_bfv_mul_relin_modswitch,
        build_ckks_mul_relin_rescale, build_ckks_poly_eval,
    )

    out = {}

    def ct_shape(ctx):
        cd = ctx.first_context_data()
        L = len(cd.parms.coeff_modulus)
        return (2, L, cd.parms.poly_modulus_degree)

    def zeros(shape):
        return np.zeros(shape, dtype=np.uint64)

    if "1" in keys:
        n = 4096
        parms = EncryptionParameters(SchemeType.BFV)
        parms.set_poly_modulus_degree(n)
        parms.set_coeff_modulus(CoeffModulus.bfv_default(n))
        parms.set_plain_modulus(PlainModulus.batching(n, 20))
        parms.set_random_seed(tuple(range(8)))
        ctx = SealContext(parms, sec_level=SecLevelType.tc128)
        kg = KeyGenerator(ctx)
        rk = kg.relin_keys()
        rk_data = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
        fn = build_bfv_mul_relin(ctx)
        x = zeros((BATCH,) + ct_shape(ctx))
        counts, macs = _trace(lambda a, k: fn(a, a, k), x, rk_data)
        out["1"] = {"n": n, "ops": BATCH, "counts": counts, "macs": macs}

    if "2" in keys:
        import jax.numpy as jnp

        from gemini_seal.ops.dyadic import add_poly
        from gemini_seal.ops.keyswitch import KeySwitchPlan, switch_key
        n = 8192
        parms = EncryptionParameters(SchemeType.BFV)
        parms.set_poly_modulus_degree(n)
        parms.set_coeff_modulus(CoeffModulus.bfv_default(n))
        parms.set_plain_modulus(PlainModulus.batching(n, 20))
        parms.set_random_seed(tuple(range(8)))
        ctx = SealContext(parms, sec_level=SecLevelType.tc128)
        kg = KeyGenerator(ctx)
        tool = ctx.first_context_data().galois_tool
        elt = tool.get_elt_from_step(1)
        gk = kg.galois_keys([elt])
        plan = KeySwitchPlan(ctx, ctx.first_parms_id)
        limbs = ctx.first_context_data().limb_constants
        gk_data = np.stack([np.asarray(pk.data.data) for pk in gk.key(elt)])

        def bfv_rotate(x, k):
            c0 = tool.apply_galois(x[..., 0, :, :], elt, limbs)
            c1 = tool.apply_galois(x[..., 1, :, :], elt, limbs)
            d0, d1 = switch_key(c1, k, plan, False)
            return jnp.stack([add_poly(c0, d0, limbs), d1], axis=-3)

        x = zeros((BATCH,) + ct_shape(ctx))
        counts, macs = _trace(bfv_rotate, x, gk_data)
        out["2"] = {"n": n, "ops": BATCH, "counts": counts, "macs": macs}

    if "3" in keys:
        n = 8192
        parms = EncryptionParameters(SchemeType.BFV)
        parms.set_poly_modulus_degree(n)
        parms.set_coeff_modulus(CoeffModulus.create(n, [50, 40, 40, 40, 50]))
        parms.set_plain_modulus(PlainModulus.batching(n, 20))
        parms.set_random_seed(tuple(range(8)))
        ctx = SealContext(parms, sec_level=SecLevelType.none)
        kg = KeyGenerator(ctx)
        rk = kg.relin_keys()
        rk_data = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
        fn = build_bfv_mul_relin_modswitch(ctx, fused_drop=True)
        x = zeros((BATCH,) + ct_shape(ctx))
        counts, macs = _trace(lambda a, k: fn(a, a, k), x, rk_data)
        out["3"] = {"n": n, "ops": BATCH, "counts": counts, "macs": macs}

    for key, n, bits in [("4", 16384, [50, 40, 40, 40, 40, 50]),
                         ("4p", 8192, [50, 40, 40, 50])]:
        if key not in keys:
            continue
        parms = EncryptionParameters(SchemeType.CKKS)
        parms.set_poly_modulus_degree(n)
        parms.set_coeff_modulus(CoeffModulus.create(n, bits))
        parms.set_random_seed(tuple(range(8)))
        ctx = SealContext(parms, sec_level=SecLevelType.none)
        kg = KeyGenerator(ctx)
        rk = kg.relin_keys()
        rk_data = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
        fn = build_ckks_mul_relin_rescale(ctx)
        x = zeros((BATCH,) + ct_shape(ctx))
        counts, macs = _trace(lambda a, k: fn(a, a, k), x, rk_data)
        out[key] = {"n": n, "ops": BATCH, "counts": counts, "macs": macs}

    if "5" in keys:
        n = 32768
        parms = EncryptionParameters(SchemeType.CKKS)
        parms.set_poly_modulus_degree(n)
        parms.set_coeff_modulus(
            CoeffModulus.create(n, [59, 40, 40, 40, 40, 40, 40, 59]))
        parms.set_random_seed(tuple(range(8)))
        ctx = SealContext(parms, sec_level=SecLevelType.none)
        kg = KeyGenerator(ctx)
        encoder = CKKSEncoder(ctx)
        tool = ctx.first_context_data().galois_tool
        rk = kg.relin_keys()
        elts = [tool.get_elt_from_step(s_) for s_ in (1, 2, 3)]
        gk = kg.galois_keys(elts)
        stepfn, _, _ = build_ckks_poly_eval(
            ctx, [1.0, -0.5, 0.25, 0.125, 0.0625], 2.0 ** 40, encoder,
            rotate_sum_log2=2, coeff_precision_bits=25, composed=True,
            rotate_mode="flat")
        rk_data = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
        gk_stack = np.stack([
            np.stack([np.asarray(pk.data.data) for pk in gk.key(e)])
            for e in elts])
        x = zeros((BATCH,) + ct_shape(ctx))
        counts, macs = _trace(stepfn, x, rk_data, gk_stack)
        out["5"] = {"n": n, "ops": BATCH, "counts": counts, "macs": macs}

    return out


def floor_table(profiles, rates=None):
    """Per-op work profile of each config; with rates, its modeled floor."""
    rows = []
    for key, p in sorted(profiles.items()):
        ops = p["ops"]
        t = 0.0
        fwd_rows = inv_rows = 0
        for (kind, n), r in sorted(p["counts"].items()):
            if rates is not None:
                fr, ir = rates["ntt"][n]
                t += r / (fr if kind == "fwd" else ir)
            if kind == "fwd":
                fwd_rows += r
            else:
                inv_rows += r
        row = {
            "config": key, "n": p["n"],
            "fwd_rows_per_op": fwd_rows / ops,
            "inv_rows_per_op": inv_rows / ops,
            "gmac_per_op": p["macs"] / ops / 1e9,
        }
        if rates is not None:
            t_mac = p["macs"] / rates["mac_g"]
            row.update(t_ntt_us=t / ops * 1e6, t_mac_us=t_mac / ops * 1e6,
                       floor_ops_s=ops / (t + t_mac))
        rows.append(row)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--measure", action="store_true",
                    help="measure NTT/MAC rates on the GPU and print floors")
    ap.add_argument("--only", default="1,2,3,4,4p,5")
    cfg = ap.parse_args()

    import jax

    from gemini_seal import compile_cache

    if cfg.measure:
        from gemini_seal.devices import require_gpu

        require_gpu(jax.default_backend(), "floor_model.py --measure")
    else:
        # tracing never executes: the CPU does it anywhere
        jax.config.update("jax_platforms", "cpu")
    compile_cache.enable()

    rates = _emit_rates() if cfg.measure else None
    keys = set(cfg.only.split(","))
    profiles = trace_configs(keys)
    for row in floor_table(profiles, rates):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
