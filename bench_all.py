"""Full benchmark suite: the five BASELINE.md configs and more cells.

bench.py (the single-line benchmark) measures config 4's hot op; this
suite covers every BASELINE config end to end, one JSON line per metric.
Every timed call ends in ``block_until_ready`` on the step's real output,
and every line names the device it ran on.

Usage: python bench_all.py [--batch 16] [--only 1,2,...] [--small]

It refuses to run without a GPU, except with ``--small``: a quick smoke
at shrunken N on whatever backend JAX has (its rates are not device
numbers).
"""

import argparse
import json


def _rate(step, args, items):
    """Items per second of ``step(*args)`` at steady state."""
    from gemini_seal.devices import time_calls

    return items / time_calls(step, args)


_DEVICE = {}


def emit(metric, value, unit):
    print(json.dumps({"metric": metric, "value": value, "unit": unit,
                      "device": _DEVICE}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--only", default="",
                    help="comma list of configs to run in isolation "
                         "(1..5, extra, cnn, train, bootstrap, logreg, relu, "
                         "matmul, attention, 65536); empty = all")
    cfg = ap.parse_args()
    _sel = set(x for x in cfg.only.split(",") if x)

    def _want(key):
        return not _sel or key in _sel

    import jax
    import jax.numpy as jnp
    import numpy as np

    from gemini_seal import compile_cache
    from gemini_seal.devices import card_line, device_record, require_gpu

    if not cfg.small:
        require_gpu(jax.default_backend(), "bench_all.py (without --small)")
        print(f"card: {card_line()}", flush=True)
    compile_cache.enable()
    _DEVICE.update(device_record(jax.devices()[:1]))

    from gemini_seal import (
        BatchEncoder, CKKSEncoder, CoeffModulus, Decryptor,
        EncryptionParameters, Encryptor, KeyGenerator, PlainModulus,
        SchemeType, SecLevelType, SealContext,
    )
    from gemini_seal.models.pipelines import (
        build_bfv_mul_relin, build_ckks_mul_relin_rescale,
        build_ckks_poly_eval, build_ckks_rotate,
    )
    from gemini_seal.ops.ntt import ntt_forward

    B = cfg.batch
    small = cfg.small

    # ---- config 1: BFV encrypt/add/multiply/decrypt, N=4096 -------------
    if _want("1"):
        n = 1024 if small else 4096
        parms = EncryptionParameters(SchemeType.BFV)
        parms.set_poly_modulus_degree(n)
        parms.set_coeff_modulus(CoeffModulus.bfv_default(n) if not small
                                else CoeffModulus.create(n, [30, 30, 30]))
        parms.set_plain_modulus(PlainModulus.batching(n, 20))
        parms.set_random_seed(tuple(range(8)))
        ctx = SealContext(parms, sec_level=SecLevelType.none if small else SecLevelType.tc128)
        kg = KeyGenerator(ctx)
        enc = Encryptor(ctx, public_key=kg.public_key())
        be = BatchEncoder(ctx)
        ct = enc.encrypt(be.encode(list(range(n))))
        a = np.broadcast_to(np.asarray(ct.data), (B,) + ct.data.shape)
        rk = kg.relin_keys()
        rk_data = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
        step = jax.jit(build_bfv_mul_relin(ctx))
        da, dk = jax.device_put(a), jax.device_put(rk_data)
        ops = _rate(lambda x, k: step(x, x, k), (da, dk), B)
        emit(f"bfv_mul_relin_n{n}_ops_per_s", ops, "ciphertext_ops/s")

    # ---- config 2: BFV rotate_rows, N=8192 ------------------------------
    if _want("2"):
        n = 1024 if small else 8192
        parms = EncryptionParameters(SchemeType.BFV)
        parms.set_poly_modulus_degree(n)
        parms.set_coeff_modulus(CoeffModulus.bfv_default(n) if not small
                                else CoeffModulus.create(n, [30, 30, 30]))
        parms.set_plain_modulus(PlainModulus.batching(n, 20))
        parms.set_random_seed(tuple(range(8)))
        ctx = SealContext(parms, sec_level=SecLevelType.none if small else SecLevelType.tc128)
        kg = KeyGenerator(ctx)
        enc = Encryptor(ctx, public_key=kg.public_key())
        be = BatchEncoder(ctx)
        tool = ctx.first_context_data().galois_tool
        elt = tool.get_elt_from_step(1)
        gk = kg.galois_keys([elt])
        ct = enc.encrypt(be.encode(list(range(n))))
        # rotate via the generic keyswitch pipeline on power-basis data
        from gemini_seal.ops.keyswitch import KeySwitchPlan, switch_key
        from gemini_seal.ops.dyadic import add_poly
        plan = KeySwitchPlan(ctx, ctx.first_parms_id)
        limbs = ctx.first_context_data().limb_constants
        gk_data = np.stack([np.asarray(pk.data.data) for pk in gk.key(elt)])

        def bfv_rotate(x, k):
            c0 = tool.apply_galois(x[..., 0, :, :], elt, limbs)
            c1 = tool.apply_galois(x[..., 1, :, :], elt, limbs)
            d0, d1 = switch_key(c1, k, plan, False)
            return jnp.stack([add_poly(c0, d0, limbs), d1], axis=-3)

        step = jax.jit(bfv_rotate)
        a = np.broadcast_to(np.asarray(ct.data), (B,) + ct.data.shape)
        da, dk = jax.device_put(a), jax.device_put(gk_data)
        ops = _rate(lambda x, k: step(x, k), (da, dk), B)
        emit(f"bfv_rotate_rows_n{n}_ops_per_s", ops, "ciphertext_ops/s")

        # hoisted variant: 8 rotations off ONE mod-up (config 2's production
        # shape for diagonal-method workloads)
        from gemini_seal.models.pipelines import build_bfv_rotate_many
        hsteps = list(range(1, 9))
        helts = [tool.get_elt_from_step(s) for s in hsteps]
        hgk = kg.galois_keys(helts)
        hgk_stack = np.stack([
            np.stack([np.asarray(pk.data.data) for pk in hgk.key(e)]) for e in helts
        ])
        hb = max(B // 8, 2)
        ha = np.broadcast_to(np.asarray(ct.data), (hb,) + ct.data.shape)
        hstep = jax.jit(build_bfv_rotate_many(ctx, hsteps))
        dha, dhk = jax.device_put(ha), jax.device_put(hgk_stack)
        hops = _rate(lambda x, k: hstep(x, k), (dha, dhk),
                          hb * len(hsteps))
        emit(f"bfv_rotate_rows_hoisted8_n{n}_rot_per_s", hops, "rotations/s")

        # round-4 variant: counter-rotated keys — shared unpermuted digit
        # contraction, ONE signed output permutation per rotation
        from gemini_seal.models.pipelines import prepermute_galois_stack
        pk_stack = prepermute_galois_stack(tool, helts, hgk_stack)
        pstep = jax.jit(
            build_bfv_rotate_many(ctx, hsteps, prepermuted_keys=True))
        dpk = jax.device_put(pk_stack)
        pops = _rate(lambda x, k: pstep(x, k), (dha, dpk),
                          hb * len(hsteps))
        emit(f"bfv_rotate_rows_hoisted8_prepermuted_n{n}_rot_per_s", pops,
             "rotations/s")

    # ---- config 3: multiply+relin+mod_switch down the chain -------------
    if _want("3"):
        n = 1024 if small else 8192
        bits = [30, 30, 30] if small else [50, 40, 40, 40, 50]
        parms = EncryptionParameters(SchemeType.BFV)
        parms.set_poly_modulus_degree(n)
        parms.set_coeff_modulus(CoeffModulus.create(n, bits))
        parms.set_plain_modulus(PlainModulus.batching(n, 20))
        parms.set_random_seed(tuple(range(8)))
        ctx = SealContext(parms, sec_level=SecLevelType.none)
        kg = KeyGenerator(ctx)
        enc = Encryptor(ctx, public_key=kg.public_key())
        be = BatchEncoder(ctx)
        rk = kg.relin_keys()
        rk_data = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
        ct = enc.encrypt(be.encode([3] * n))
        # one fused program: BEHZ multiply + relin + ONE CRT multi-drop over
        # all dropped primes (decrypt-equal; noise pinned in test_noise)
        from gemini_seal.models.pipelines import build_bfv_mul_relin_modswitch
        chain = build_bfv_mul_relin_modswitch(ctx, fused_drop=True)
        step = jax.jit(chain)
        a = np.broadcast_to(np.asarray(ct.data), (B,) + ct.data.shape)
        da, dk = jax.device_put(a), jax.device_put(rk_data)
        ops = _rate(lambda x, k: step(x, x, k), (da, dk), B)
        emit(f"bfv_mul_relin_chain_n{n}_ops_per_s", ops, "ciphertext_ops/s")

        # dedicated square vs multiply at the same config (one base
        # extension + 3-product convolution)
        mulstep = jax.jit(build_bfv_mul_relin(ctx))
        sqstep = jax.jit(build_bfv_mul_relin(ctx, square=True))
        mops = _rate(lambda x, k: mulstep(x, x, k), (da, dk), B)
        sops = _rate(lambda x, k: sqstep(x, k), (da, dk), B)
        emit(f"bfv_mul_relin_n{n}_ops_per_s", mops, "ciphertext_ops/s")
        emit(f"bfv_square_relin_n{n}_ops_per_s", sops, "ciphertext_ops/s")
        emit(f"bfv_square_vs_mul_n{n}_speedup", sops / mops, "x")

    # ---- config 4: CKKS mult+relin+rescale, N=16384 ----------------------
    if _want("4"):
        n = 1024 if small else 16384
        bits = [40, 30, 40] if small else [50, 40, 40, 40, 40, 50]
        parms = EncryptionParameters(SchemeType.CKKS)
        parms.set_poly_modulus_degree(n)
        parms.set_coeff_modulus(CoeffModulus.create(n, bits))
        parms.set_random_seed(tuple(range(8)))
        ctx = SealContext(parms, sec_level=SecLevelType.none)
        kg = KeyGenerator(ctx)
        enc = Encryptor(ctx, public_key=kg.public_key())
        encoder = CKKSEncoder(ctx)
        rk = kg.relin_keys()
        rk_data = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
        ct = enc.encrypt(encoder.encode([1.001] * encoder.slot_count, 2.0 ** 40))
        step = jax.jit(build_ckks_mul_relin_rescale(ctx))
        a = np.broadcast_to(np.asarray(ct.data), (B,) + ct.data.shape)
        da, dk = jax.device_put(a), jax.device_put(rk_data)
        ops = _rate(lambda x, k: step(x, x, k), (da, dk), B)
        emit(f"ckks_mul_relin_rescale_n{n}_ops_per_s", ops, "ciphertext_ops/s")

        # NTT/s per chip at the same config
        tables = ctx.first_context_data().ntt_tables
        L = len(ctx.first_context_data().parms.coeff_modulus)
        nttstep = jax.jit(lambda x: ntt_forward(x, tables))
        x = np.asarray(ct.data)[None].repeat(B, 0)
        dx = jax.device_put(x)
        per = _rate(lambda x: nttstep(x), (dx,), B * 2 * L)
        emit(f"ntt_n{n}_per_s", per, "poly_limb_ntts/s")

    # ---- config 5: deep CKKS poly eval + rotations, N=32768 -------------
    if _want("5"):
        n = 1024 if small else 32768
        bits = [59, 30, 30, 30, 59] if small else [59, 40, 40, 40, 40, 40, 40, 59]
        scale = 2.0 ** 30 if small else 2.0 ** 40
        parms = EncryptionParameters(SchemeType.CKKS)
        parms.set_poly_modulus_degree(n)
        parms.set_coeff_modulus(CoeffModulus.create(n, bits))
        parms.set_random_seed(tuple(range(8)))
        ctx = SealContext(parms, sec_level=SecLevelType.none)
        kg = KeyGenerator(ctx)
        enc = Encryptor(ctx, public_key=kg.public_key())
        encoder = CKKSEncoder(ctx)
        tool = ctx.first_context_data().galois_tool
        rk = kg.relin_keys()
        # flat hoisted rotation-sum: keys for steps 1..3, ONE mod-up + ONE
        # mod-down instead of two sequential key switches
        elts = [tool.get_elt_from_step(s_) for s_ in (1, 2, 3)]
        gk = kg.galois_keys(elts)
        coeffs = [1.0, -0.5, 0.25, 0.125, 0.0625]
        # composed=True: one jitted program per level + one combine
        # program, which compiles far faster than the monolithic deep graph
        stepfn, deep_id, out_scale = build_ckks_poly_eval(
            ctx, coeffs, scale, encoder, rotate_sum_log2=2,
            coeff_precision_bits=25, composed=True, rotate_mode="flat",
        )
        ct = enc.encrypt(encoder.encode([0.5] * encoder.slot_count, scale))
        rk_data = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
        gk_stack = np.stack([
            np.stack([np.asarray(pk.data.data) for pk in gk.key(e)]) for e in elts
        ])
        deep_batch = B
        a = np.broadcast_to(np.asarray(ct.data), (deep_batch,) + ct.data.shape)
        da = jax.device_put(a)
        dk = jax.device_put(rk_data)
        dg = jax.device_put(gk_stack)
        ops = _rate(stepfn, (da, dk, dg),
                         deep_batch)
        emit(f"ckks_deep_poly4_rot_n{n}_ops_per_s", ops, "ciphertext_ops/s")

    # ---- extra: encrypted dense-layer matvec (hoisted rotations) --------
    if _want("extra"):
        n = 1024 if small else 8192
        bits = [40, 30, 40] if small else [50, 40, 40, 50]
        parms = EncryptionParameters(SchemeType.CKKS)
        parms.set_poly_modulus_degree(n)
        parms.set_coeff_modulus(CoeffModulus.create(n, bits))
        parms.set_random_seed(tuple(range(8)))
        ctx = SealContext(parms, sec_level=SecLevelType.none)
        kg = KeyGenerator(ctx)
        enc = Encryptor(ctx, public_key=kg.public_key())
        encoder = CKKSEncoder(ctx)
        tool = ctx.first_context_data().galois_tool
        from gemini_seal.models.pipelines import build_ckks_matvec
        dim = 8
        rng = np.random.default_rng(1)
        M = rng.uniform(-0.5, 0.5, size=(dim, dim))
        slots = encoder.slot_count
        diagonals = {
            dd: [M[i % dim, (i + dd) % dim] for i in range(slots)]
            for dd in range(dim)
        }
        msteps = sorted(s for s in diagonals if s != 0)
        elts = [tool.get_elt_from_step(s) for s in msteps]
        gk = kg.galois_keys(elts)
        gk_stack = np.stack([
            np.stack([np.asarray(pk.data.data) for pk in gk.key(e)]) for e in elts
        ])
        x = enc.encrypt(encoder.encode([0.5] * slots, 2.0 ** 40))
        mb = max(B // 8, 2)
        a = np.broadcast_to(np.asarray(x.data), (mb,) + x.data.shape)
        step = jax.jit(build_ckks_matvec(ctx, diagonals, 2.0 ** 40, encoder))
        da, dk = jax.device_put(a), jax.device_put(gk_stack)
        ops = _rate(lambda c, k: step(c, k), (da, dk), mb)
        emit(f"ckks_dense8x8_hoisted_n{n}_layers_per_s", ops, "encrypted_layers/s")

    # ---- cnn: whole encrypted CNN inference (ex11 network) --------------
    if _want("cnn"):
        n = 1024 if small else 4096
        bits = ([50, 40, 40, 40, 40, 50] if small
                else [50, 40, 40, 40, 40, 40, 40, 50])
        parms = EncryptionParameters(SchemeType.CKKS)
        parms.set_poly_modulus_degree(n)
        parms.set_coeff_modulus(CoeffModulus.create(n, bits))
        parms.set_random_seed(tuple(range(8)))
        ctx = SealContext(parms, sec_level=SecLevelType.none)
        kg = KeyGenerator(ctx)
        enc = Encryptor(ctx, public_key=kg.public_key())
        encoder = CKKSEncoder(ctx)
        tool = ctx.first_context_data().galois_tool
        rk = kg.relin_keys()
        from gemini_seal.models.pipelines import build_ckks_cnn
        h = w = 8 if small else 16
        hw = h * w
        rng = np.random.default_rng(2)
        slots = encoder.slot_count
        kern = rng.uniform(-0.4, 0.4, size=(3, 3))
        M = np.zeros((hw, hw))
        for d in range(16):
            for i in range(hw):
                M[i, (i + d) % hw] = rng.uniform(-0.15, 0.15)
        R = np.zeros((hw, hw))
        for d in range(10):
            for i in range(hw):
                R[i, (i + d) % hw] = rng.uniform(-0.3, 0.3)
        diagonals = {d: [M[i % hw, (i + d) % hw] for i in range(slots)]
                     for d in range(16)}
        readout = {d: [R[i % hw, (i + d) % hw] for i in range(slots)]
                   for d in range(10)}
        if small:
            cnn_dense = [(readout, [0.0] * slots, None)]
        else:
            cnn_dense = [(diagonals, [0.0] * slots, "square"),
                         (readout, [0.0] * slots, None)]
        fn, _pid, _osc = build_ckks_cnn(
            ctx, convs=[(kern, None, "square")], dense=cnn_dense,
            height=h, width=w, scale=2.0 ** 40, encoder=encoder, bsgs=True,
        )
        gk_stacks = []
        for layer_steps in fn.rot_steps:
            elts = [tool.get_elt_from_step(s) for s in layer_steps]
            gk = kg.galois_keys(elts)
            gk_stacks.append(jax.device_put(gk.stacked(*elts)))
        img = [rng.uniform(0, 1) for _ in range(hw)]
        x = enc.encrypt(encoder.encode(
            [img[i % hw] for i in range(slots)], 2.0 ** 40))
        cb = max(B // 8, 2)
        a = np.broadcast_to(np.asarray(x.data), (cb,) + x.data.shape)
        nst = len(gk_stacks)
        step = jax.jit(lambda c, r, *gs: fn(c, gs, r))
        da, dr = jax.device_put(a), jax.device_put(rk.stacked(2))
        ops = _rate(lambda c, r, *gs: step(c, r, *gs),
                         (da, dr) + tuple(gk_stacks), cb)
        emit(f"ckks_cnn{h}x{h}_n{n}_images_per_s", ops,
             "encrypted_images/s")

    # ---- train: encrypted logreg gradient-descent iteration -------------
    if _want("train"):
        n = 1024 if small else 8192
        bits = [50] + [40] * 7 + [50]
        parms = EncryptionParameters(SchemeType.CKKS)
        parms.set_poly_modulus_degree(n)
        parms.set_coeff_modulus(CoeffModulus.create(n, bits))
        parms.set_random_seed(tuple(range(8)))
        ctx = SealContext(parms, sec_level=SecLevelType.none)
        kg = KeyGenerator(ctx)
        enc = Encryptor(ctx, public_key=kg.public_key())
        encoder = CKKSEncoder(ctx)
        tool = ctx.first_context_data().galois_tool
        rk = kg.relin_keys()
        from gemini_seal.models.pipelines import build_ckks_logreg_train_step
        m, F = (16, 8) if small else (64, 16)
        rng = np.random.default_rng(4)
        y = rng.integers(0, 2, size=m).astype(float)
        fn, _pid, _osc, rsteps = build_ckks_logreg_train_step(
            ctx, m, F, y.tolist(), 0.1, 2.0 ** 40, encoder)
        elts = [tool.get_elt_from_step(s) for s in rsteps]
        gk = kg.galois_keys(elts)
        slots = encoder.slot_count
        Bf = 1 << int(np.ceil(np.log2(F)))
        xs = np.zeros(slots)
        for i in range(m):
            xs[i * Bf:i * Bf + F] = rng.uniform(-1, 1, size=F)
        ws = np.zeros(slots)
        for i in range(slots // Bf):
            ws[i * Bf:i * Bf + F] = rng.uniform(-0.5, 0.5, size=F)
        ct_x = enc.encrypt(encoder.encode(xs.tolist(), 2.0 ** 40))
        ct_w = enc.encrypt(encoder.encode(ws.tolist(), 2.0 ** 40))
        tb = max(B // 8, 2)
        ax = np.broadcast_to(np.asarray(ct_x.data), (tb,) + ct_x.data.shape)
        aw = np.broadcast_to(np.asarray(ct_w.data), (tb,) + ct_w.data.shape)
        step = jax.jit(fn)
        dx, dw = jax.device_put(ax), jax.device_put(aw)
        dg = jax.device_put(gk.stacked(*elts))
        dr = jax.device_put(rk.stacked(2))
        ops = _rate(lambda X, W, g, r: step(X, W, g, r),
                         (dx, dw, dg, dr), tb)
        emit(f"ckks_logreg_train_m{m}_f{F}_n{n}_iters_per_s", ops,
             "encrypted_gd_iters/s")

    # ---- bootstrap: full CKKS ciphertext refresh -------------------------
    if _want("bootstrap"):
        # Refresh an exhausted ciphertext without decrypting (capability
        # BEYOND the reference).  linear_mode="split" (log-depth FFT-
        # factored slot maps) keeps the plaintext grids at O(2^radix)
        # diagonals per level, so N=4096 fits; --small shrinks to the
        # e2e-test shape.
        from gemini_seal.models.bootstrap import (
            build_ckks_bootstrap,
            plan_bootstrap_chain,
        )
        if small:
            n, nsp, radix = 128, 1, 3
        else:
            n, nsp, radix = 4096, 3, 4
        # 59-bit primes on every bootstrap-consumed level (the Dl_em
        # layout): collapses the q0/Dl noise amplification of the refresh
        bits, n_levels, K = plan_bootstrap_chain(n, radix=radix, nsp=nsp,
                                                 restored=2)
        parms = EncryptionParameters(SchemeType.CKKS)
        parms.set_poly_modulus_degree(n)
        parms.set_coeff_modulus(CoeffModulus.create(n, bits))
        parms.set_n_special_primes(nsp)
        parms.set_random_seed(tuple(range(8)))
        ctx = SealContext(parms, sec_level=SecLevelType.none)
        kg = KeyGenerator(ctx)
        enc = Encryptor(ctx, public_key=kg.public_key())
        encoder = CKKSEncoder(ctx)
        tool = ctx.first_context_data().galois_tool
        scale = 2.0 ** 45
        fn, out_pid, out_scale, rsteps, conj_elt = build_ckks_bootstrap(
            ctx, scale, encoder, linear_mode="split", radix=radix)
        elts = [tool.get_elt_from_step(s_) for s_ in rsteps]
        gk = kg.galois_keys(elts + [conj_elt])
        rot_stack = jax.device_put(gk.stacked(*elts))
        conj_stack = jax.device_put(gk.stacked(conj_elt))
        rks = jax.device_put(kg.relin_keys().stacked(2))
        from gemini_seal import Decryptor, Evaluator
        from gemini_seal.ciphertext import Ciphertext
        ev = Evaluator(ctx)
        dec = Decryptor(ctx, kg.secret_key)
        rng = np.random.default_rng(13)
        msg = rng.uniform(-1, 1, encoder.slot_count)
        ct = enc.encrypt(encoder.encode(msg.tolist(), scale))
        while ctx.get_context_data(ct.parms_id).next_context_data is not None:
            ct = ev.mod_switch_to_next(ct)
        da = jax.device_put(np.asarray(ct.data))
        # measured refresh precision (decrypt once before timing)
        out0 = np.asarray(fn(da, rot_stack, conj_stack, rks))
        got = np.asarray(encoder.decode(dec.decrypt(
            Ciphertext(out0, out_pid, True, out_scale)), as_complex=True))
        max_err = float(np.abs(got[: encoder.slot_count] - msg).max())
        l_out = len(ctx.get_context_data(out_pid).parms.coeff_modulus)
        ops = _rate(fn, (da, rot_stack, conj_stack, rks), 1)
        print(json.dumps({
            "metric": f"ckks_bootstrap_n{n}_refreshes_per_s",
            "value": ops, "unit": "refreshes/s",
            "max_err": max_err, "levels_restored": l_out,
            "levels_consumed": n_levels, "device": _DEVICE,
        }), flush=True)

    # ---- matmul: encrypted d x d matrix product (JKLS) ------------------
    if _want("matmul"):
        # 32 x 32 matrix product in 1024 slots at N=2048 (3 levels,
        # 93 hoisted rotations, one relin); --small: 8 x 8 at N=128.
        from gemini_seal.models.pipelines import build_ckks_matmul_square
        d = 8 if small else 32
        n = 2 * d * d
        bits = [50, 40, 40, 40, 40, 50]
        parms = EncryptionParameters(SchemeType.CKKS)
        parms.set_poly_modulus_degree(n)
        parms.set_coeff_modulus(CoeffModulus.create(n, bits))
        parms.set_random_seed(tuple(range(8)))
        ctx = SealContext(parms, sec_level=SecLevelType.none)
        kg = KeyGenerator(ctx)
        enc = Encryptor(ctx, public_key=kg.public_key())
        encoder = CKKSEncoder(ctx)
        tool = ctx.first_context_data().galois_tool
        scale = 2.0 ** 40
        fn, out_pid, out_scale = build_ckks_matmul_square(ctx, d, scale,
                                                          encoder)
        elts = [tool.get_elt_from_step(s_) for s_ in fn.rot_steps]
        gk = kg.galois_keys(elts)
        rng = np.random.default_rng(5)
        ctA = enc.encrypt(encoder.encode(
            rng.uniform(-1, 1, d * d).tolist(), scale))
        ctB = enc.encrypt(encoder.encode(
            rng.uniform(-1, 1, d * d).tolist(), scale))
        lb = max(B // 8, 2)
        a = np.broadcast_to(np.asarray(ctA.data), (lb,) + ctA.data.shape)
        b = np.broadcast_to(np.asarray(ctB.data), (lb,) + ctB.data.shape)
        step = jax.jit(fn)
        da, db = jax.device_put(a), jax.device_put(b)
        dg = jax.device_put(gk.stacked(*elts))
        dr = jax.device_put(kg.relin_keys().stacked(2))
        ops = _rate(lambda x, y, g, r: step(x, y, g, r),
                         (da, db, dg, dr), lb)
        emit(f"ckks_matmul_d{d}_n{n}_matmuls_per_s", ops,
             "encrypted_matmuls/s")

    # ---- attention: encrypted single-head attention ----------------------
    if _want("attention"):
        # softmax(Q K^T / sqrt(d)) @ V with Q, K^T, V ALL encrypted (no
        # reference analogue at any layer).  Chebyshev exp fitted over the
        # actual logit window + auto-sized Goldschmidt reciprocal
        # (attention_plan); composed per-stage jitted programs.
        from gemini_seal.ciphertext import Ciphertext
        from gemini_seal.models.pipelines import (
            attention_plan,
            build_ckks_attention,
        )
        for d in ((4,) if small else (16, 32)):
            n = 2 * d * d
            n_levels, a_iters, _bl = attention_plan(d)
            bits = [50] + [40] * n_levels + [50]
            parms = EncryptionParameters(SchemeType.CKKS)
            parms.set_poly_modulus_degree(n)
            parms.set_coeff_modulus(CoeffModulus.create(n, bits))
            parms.set_random_seed(tuple(range(8)))
            ctx = SealContext(parms, sec_level=SecLevelType.none)
            kg = KeyGenerator(ctx)
            enc = Encryptor(ctx, public_key=kg.public_key())
            encoder = CKKSEncoder(ctx)
            tool = ctx.first_context_data().galois_tool
            scale = 2.0 ** 40
            run, out_pid, out_scale, rsteps = build_ckks_attention(
                ctx, d, scale, encoder)
            elts = [tool.get_elt_from_step(s_) for s_ in rsteps]
            gk = kg.galois_keys(elts)
            rot_stack = jax.device_put(gk.stacked(*elts))
            rks = jax.device_put(kg.relin_keys().stacked(2))
            dec = Decryptor(ctx, kg.secret_key)
            rng = np.random.default_rng(23)
            Q, K, V = (rng.uniform(-0.5, 0.5, (d, d)) for _ in range(3))

            def _pack(M):
                return enc.encrypt(encoder.encode(
                    M.reshape(-1).tolist(), scale))

            ctQ, ctKT, ctV = _pack(Q), _pack(K.T), _pack(V)
            # measured softmax-attention precision (decrypt once pre-timing)
            out0 = np.asarray(run(np.asarray(ctQ.data),
                                  np.asarray(ctKT.data),
                                  np.asarray(ctV.data), rot_stack, rks))
            got = np.asarray(encoder.decode(dec.decrypt(Ciphertext(
                out0, out_pid, True, out_scale))))[: d * d].reshape(d, d)
            S_ = Q @ K.T / np.sqrt(d)
            P_ = np.exp(S_) / np.exp(S_).sum(axis=1, keepdims=True)
            max_err = float(np.abs(got - P_ @ V).max())
            lb = max(B // 8, 2)
            dq, dk, dv = (jax.device_put(np.broadcast_to(
                np.asarray(c.data), (lb,) + c.data.shape))
                for c in (ctQ, ctKT, ctV))
            ops = _rate(
                lambda q_, k_, v_: run(q_, k_, v_, rot_stack, rks),
                (dq, dk, dv), lb)
            print(json.dumps({
                "metric": f"ckks_attention_d{d}_n{n}_attns_per_s",
                "value": ops, "unit": "encrypted_attentions/s",
                "max_err": max_err, "levels": n_levels,
                "goldschmidt_iters": a_iters, "device": _DEVICE,
            }), flush=True)

    # ---- 65536: the reference's size cap -----------------------------------
    if _want("65536"):
        # N = 65536 is SEAL_POLY_MOD_DEGREE_MAX (reference defines.h:53) —
        # the one size every prior measured row stopped short of.  Times
        # the forward/inverse NTT (rows/s, comparable with the PERF.md
        # microbench sweep) and one mul+relin+rescale step.
        n = 2048 if small else 65536
        bits = [50, 40, 40, 50]
        parms = EncryptionParameters(SchemeType.CKKS)
        parms.set_poly_modulus_degree(n)
        parms.set_coeff_modulus(CoeffModulus.create(n, bits))
        parms.set_random_seed(tuple(range(8)))
        ctx = SealContext(parms, sec_level=SecLevelType.none)
        cd = ctx.first_context_data()
        tabs = cd.ntt_tables
        L = len(cd.parms.coeff_modulus)
        rng = np.random.default_rng(9)
        nb = max(B * 8192 // n, 1)
        x = np.stack([
            rng.integers(0, int(m.value), (nb, 2, n), dtype=np.uint64)
            for m in cd.parms.coeff_modulus
        ], axis=2)
        dx = jax.device_put(x)
        fstep = jax.jit(lambda y: ntt_forward(y, tabs))
        rows = nb * 2 * L
        fwd = _rate(lambda y: fstep(y), (dx,), rows)
        emit(f"ntt_fwd_n{n}_rows_per_s", fwd, "poly_limb_rows/s")
        from gemini_seal.ops.ntt import ntt_inverse
        istep = jax.jit(lambda y: ntt_inverse(y, tabs))
        inv = _rate(lambda y: istep(y), (dx,), rows)
        emit(f"ntt_inv_n{n}_rows_per_s", inv, "poly_limb_rows/s")
        kg = KeyGenerator(ctx)
        enc = Encryptor(ctx, public_key=kg.public_key())
        encoder = CKKSEncoder(ctx)
        ct = enc.encrypt(encoder.encode([0.5, -1.25, 2.0], 2.0 ** 40))
        rk = np.stack([np.asarray(pk.data.data)
                       for pk in kg.relin_keys().key(2)])
        lb = max(B // 8, 2)
        a = np.broadcast_to(np.asarray(ct.data), (lb,) + ct.data.shape)
        step = jax.jit(build_ckks_mul_relin_rescale(ctx))
        da, dk = jax.device_put(a), jax.device_put(rk)
        ops = _rate(lambda p, k: step(p, p, k), (da, dk),
                         lb)
        emit(f"ckks_mul_relin_rescale_n{n}_ops_per_s", ops, "ct_ops/s")

    # ---- relu: composite-minimax sign gate -------------------------------
    if _want("relu"):
        # ReLU over all slots: 13 levels (3 odd degree-7 stages + the
        # gate multiply), relin key only — the deep pointwise-nonlinearity
        # workload.  --small shrinks N.
        from gemini_seal.models.pipelines import build_ckks_relu
        n = 256 if small else 8192
        bits = [50] + [40] * 13 + [50]
        parms = EncryptionParameters(SchemeType.CKKS)
        parms.set_poly_modulus_degree(n)
        parms.set_coeff_modulus(CoeffModulus.create(n, bits))
        parms.set_random_seed(tuple(range(8)))
        ctx = SealContext(parms, sec_level=SecLevelType.none)
        kg = KeyGenerator(ctx)
        enc = Encryptor(ctx, public_key=kg.public_key())
        encoder = CKKSEncoder(ctx)
        scale = 2.0 ** 40
        fn, out_pid, out_scale = build_ckks_relu(ctx, scale, encoder)
        rng = np.random.default_rng(7)
        ct = enc.encrypt(encoder.encode(
            rng.uniform(-1, 1, encoder.slot_count).tolist(), scale))
        lb = max(B // 8, 2)
        a = np.broadcast_to(np.asarray(ct.data), (lb,) + ct.data.shape)
        step = jax.jit(fn)
        da = jax.device_put(a)
        dr = jax.device_put(kg.relin_keys().stacked(2))
        ops = _rate(lambda c, r: step(c, r), (da, dr),
                         lb)
        emit(f"ckks_relu_n{n}_ops_per_s", ops, "encrypted_relus/s")

    # ---- logreg: encrypted logistic-regression head ---------------------
    if _want("logreg"):
        n = 1024 if small else 8192
        bits = [50, 40, 40, 40, 40, 50]
        parms = EncryptionParameters(SchemeType.CKKS)
        parms.set_poly_modulus_degree(n)
        parms.set_coeff_modulus(CoeffModulus.create(n, bits))
        parms.set_random_seed(tuple(range(8)))
        ctx = SealContext(parms, sec_level=SecLevelType.none)
        kg = KeyGenerator(ctx)
        enc = Encryptor(ctx, public_key=kg.public_key())
        encoder = CKKSEncoder(ctx)
        tool = ctx.first_context_data().galois_tool
        rk = kg.relin_keys()
        from gemini_seal.models.pipelines import build_ckks_logreg
        F = 16
        rng = np.random.default_rng(3)
        wts = rng.uniform(-0.4, 0.4, size=F)
        fn, _pid, _osc, rsteps = build_ckks_logreg(
            ctx, wts.tolist(), 0.25, 2.0 ** 40, encoder)
        elts = [tool.get_elt_from_step(s) for s in rsteps]
        gk = kg.galois_keys(elts)
        slots = encoder.slot_count
        xs = [0.0] * slots
        xs[:F] = rng.uniform(-1, 1, size=F).tolist()
        x = enc.encrypt(encoder.encode(xs, 2.0 ** 40))
        lb = max(B // 8, 2)
        a = np.broadcast_to(np.asarray(x.data), (lb,) + x.data.shape)
        step = jax.jit(fn)
        da = jax.device_put(a)
        dg = jax.device_put(gk.stacked(*elts))
        dr = jax.device_put(rk.stacked(2))
        ops = _rate(lambda c, g, r: step(c, g, r), (da, dg, dr),
                         lb)
        emit(f"ckks_logreg_f{F}_n{n}_inferences_per_s", ops,
             "encrypted_inferences/s")


if __name__ == "__main__":
    main()
