"""Run the serving path once on one GPU and check it bit for bit.

    python chip_smoke.py                # the four one-card phases
    python chip_smoke.py --four-cards   # only the sharded schedules, 4 cards

One-card phases, at 128-bit-secure parameters (tc128):

- ``ckks_served``: CKKS N=8192 {50,40,40,50}, scale 2^40, batch 128.
  Host keygen and encrypt, SEAL-wire requests through
  ``EncryptedComputeServer`` around the fused multiply+relinearize+rescale
  step, wire egress, host decrypt.  The unfused step on the same batch is
  compared bit for bit with the host ``Evaluator``; the fused result
  decodes within 1e-4 of the true product and 1e-5 of the unfused one.
- ``bfv_served``: BFV N=4096 ``bfv_default``, 20-bit batching plain
  modulus, multiply+relinearize served; bit-exact against the host
  ``Evaluator`` and exact after decryption.
- ``rotate_many``: the hoisted 8-step ``build_ckks_rotate_many`` at the
  CKKS shape; bit-exact against the host's hoisted
  ``rotate_vector_many``, and within 1e-4 of ``rotate_vector`` and of the
  rotated message after decryption (one shared mod-up rounds differently
  from a fresh key switch per step).
- ``device_evaluator``: ``DeviceEvaluator`` multiply -> relinearize ->
  rescale_to_next; bit-exact against the host chain.

Each phase checks 4 ciphertexts of its batch against the host plane and
prints its shape, compile seconds, a steady-state rate (informative; every
timed call ends in ``block_until_ready``), the compiled program's memory
analysis and the device's peak bytes in use.  Any mismatch raises, and the
script exits non-zero.

``--four-cards`` runs only the multi-device schedules of
``gemini_seal.parallel`` on a 4-card mesh, each compared bit for bit with
the same step on one card, with the step time and the collective bytes
that ``parallel/comm.py`` counts in the compiled program.

Without a GPU the script exits non-zero before any phase.  The last line
of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

CHECK = 4          # ciphertexts of each batch compared with the host plane
CKKS_BITS = (50, 40, 40, 50)


# ---------------------------------------------------------------------------
# set-up and reporting helpers


def _ckks(n, bits, sec, nsp=1, seed=tuple(range(71, 79))):
    from gemini_seal import (
        CKKSEncoder, CoeffModulus, Decryptor, EncryptionParameters,
        Encryptor, Evaluator, KeyGenerator, SchemeType, SealContext,
    )

    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, list(bits)))
    parms.set_n_special_primes(nsp)
    parms.set_random_seed(seed)
    ctx = SealContext(parms, sec_level=sec)
    kg = KeyGenerator(ctx)
    return (ctx, kg, Encryptor(ctx, public_key=kg.public_key()),
            CKKSEncoder(ctx), Decryptor(ctx, kg.secret_key), Evaluator(ctx))


def _bfv(n, coeff, sec, seed=tuple(range(81, 89))):
    from gemini_seal import (
        BatchEncoder, Decryptor, EncryptionParameters, Encryptor, Evaluator,
        KeyGenerator, PlainModulus, SchemeType, SealContext,
    )

    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(coeff)
    parms.set_plain_modulus(PlainModulus.batching(n, 20))
    parms.set_random_seed(seed)
    ctx = SealContext(parms, sec_level=sec)
    kg = KeyGenerator(ctx)
    return (ctx, kg, Encryptor(ctx, public_key=kg.public_key()),
            BatchEncoder(ctx), Decryptor(ctx, kg.secret_key), Evaluator(ctx))


def _tc128():
    from gemini_seal import SecLevelType

    return SecLevelType.tc128


def _aot(fn, *args):
    """Compile ``fn`` for ``args``; (compiled, seconds)."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def _memory(compiled):
    ma = compiled.memory_analysis()
    if ma is None:
        return None
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {f: int(getattr(ma, f)) for f in fields if hasattr(ma, f)}


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if not stats else stats.get("peak_bytes_in_use")


def _equal(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(f"{what}: device result differs from host plane")


def _slot_values(rng, n_slots):
    return rng.uniform(-1.0, 1.0, n_slots)


# ---------------------------------------------------------------------------
# one-card phases


def ckks_served(n=8192, bits=CKKS_BITS, sec=None, batch=128, scale=2.0 ** 40,
                check=CHECK, timed=True):
    """CKKS multiply+relinearize+rescale through the wire-to-wire server."""
    import jax

    from gemini_seal import serialization as ser
    from gemini_seal.ciphertext import Ciphertext
    from gemini_seal.devices import time_calls
    from gemini_seal.models.pipelines import build_ckks_mul_relin_rescale
    from gemini_seal.models.serving import EncryptedComputeServer

    sec = _tc128() if sec is None else sec
    ctx, kg, enc, encoder, dec, ev = _ckks(n, bits, sec)
    rk = kg.relin_keys()
    rk_data = rk.stacked(2)
    cd = ctx.first_context_data()
    nxt = cd.next_context_data.parms_id
    out_scale = scale * scale / cd.parms.coeff_modulus[-1].value
    rng = np.random.default_rng(1)
    ma = [_slot_values(rng, encoder.slot_count) for _ in range(check)]
    mb = [_slot_values(rng, encoder.slot_count) for _ in range(check)]
    ca = [enc.encrypt(encoder.encode(m.tolist(), scale)) for m in ma]
    cb = [enc.encrypt(encoder.encode(m.tolist(), scale)) for m in mb]
    blobs = [(ser.save(a), ser.save(b)) for a, b in zip(ca, cb)]
    reqs = [blobs[i % check] for i in range(batch)]

    fused = build_ckks_mul_relin_rescale(ctx, fused=True)
    host_a = np.stack([np.asarray(ca[i % check].data) for i in range(batch)])
    host_b = np.stack([np.asarray(cb[i % check].data) for i in range(batch)])
    da, db, dk = (jax.device_put(x) for x in (host_a, host_b, rk_data))
    compiled, compile_s = _aot(fused, da, db, dk)

    server = EncryptedComputeServer(
        ctx, fused, [rk_data], out_parms_id=nxt, out_is_ntt=True,
        out_scale=out_scale, batch_size=batch, n_inputs=2)
    outs = server.submit(reqs)
    served = np.stack([np.asarray(ser.load_ciphertext(o, ctx).data)
                       for o in outs])
    for i in range(batch):  # repeated requests give repeated answers
        _equal(served[i], served[i % check], f"served row {i}")

    # the unfused step is the host plane's exact dataflow
    seq = np.asarray(jax.jit(build_ckks_mul_relin_rescale(ctx))(da, db, dk))
    worst = 0.0
    for i in range(check):
        want = ev.rescale_to_next(ev.relinearize(ev.multiply(ca[i], cb[i]), rk))
        _equal(seq[i], want.data, f"unfused row {i}")
        got_f = np.asarray(encoder.decode(
            dec.decrypt(Ciphertext(served[i], nxt, True, out_scale))))
        got_s = np.asarray(encoder.decode(
            dec.decrypt(Ciphertext(seq[i], nxt, True, out_scale))))
        err = float(np.abs(got_f - ma[i] * mb[i]).max())
        if not (np.all(np.isfinite(got_f)) and err < 1e-4):
            raise AssertionError(f"fused row {i}: max slot error {err}")
        gap = float(np.abs(got_f - got_s).max())
        if gap >= 1e-5:
            raise AssertionError(f"fused vs unfused row {i}: {gap}")
        worst = max(worst, err)

    rec = {"phase": "ckks_served", "n": n, "bits": list(bits),
           "batch": batch, "out_shape": list(served.shape),
           "compile_s": compile_s, "memory": _memory(compiled),
           "max_slot_error": worst, "bit_exact_unfused": True}
    if timed:
        step_s = time_calls(compiled, (da, db, dk))
        t0 = time.perf_counter()
        for _ in range(3):
            server.submit(reqs)
        rec["device_ops_per_s"] = batch / step_s
        rec["served_requests_per_s"] = 3 * batch / (time.perf_counter() - t0)
    rec["peak_bytes_in_use"] = _peak_bytes()
    return rec


def bfv_served(n=4096, coeff=None, sec=None, batch=128, check=CHECK,
               timed=True):
    """BFV multiply+relinearize through the wire-to-wire server."""
    import jax

    from gemini_seal import CoeffModulus
    from gemini_seal import serialization as ser
    from gemini_seal.ciphertext import Ciphertext
    from gemini_seal.devices import time_calls
    from gemini_seal.models.pipelines import build_bfv_mul_relin
    from gemini_seal.models.serving import EncryptedComputeServer

    sec = _tc128() if sec is None else sec
    coeff = CoeffModulus.bfv_default(n) if coeff is None else coeff
    ctx, kg, enc, be, dec, ev = _bfv(n, coeff, sec)
    rk = kg.relin_keys()
    rk_data = rk.stacked(2)
    t = ctx.first_context_data().parms.plain_modulus.value
    rng = np.random.default_rng(2)
    ma = [rng.integers(0, t, be.slot_count) for _ in range(check)]
    mb = [rng.integers(0, t, be.slot_count) for _ in range(check)]
    ca = [enc.encrypt(be.encode(m.tolist())) for m in ma]
    cb = [enc.encrypt(be.encode(m.tolist())) for m in mb]
    blobs = [(ser.save(a), ser.save(b)) for a, b in zip(ca, cb)]
    reqs = [blobs[i % check] for i in range(batch)]

    step = build_bfv_mul_relin(ctx)
    host_a = np.stack([np.asarray(ca[i % check].data) for i in range(batch)])
    host_b = np.stack([np.asarray(cb[i % check].data) for i in range(batch)])
    da, db, dk = (jax.device_put(x) for x in (host_a, host_b, rk_data))
    compiled, compile_s = _aot(step, da, db, dk)

    pid = ctx.first_parms_id
    server = EncryptedComputeServer(
        ctx, step, [rk_data], out_parms_id=pid, out_is_ntt=False,
        out_scale=1.0, batch_size=batch, n_inputs=2)
    outs = server.submit(reqs)
    served = np.stack([np.asarray(ser.load_ciphertext(o, ctx).data)
                       for o in outs])
    for i in range(batch):
        _equal(served[i], served[i % check], f"served row {i}")
    for i in range(check):
        want = ev.relinearize(ev.multiply(ca[i], cb[i]), rk)
        _equal(served[i], want.data, f"served row {i}")
        got = np.asarray(be.decode(dec.decrypt(
            Ciphertext(served[i], pid, False, 1.0))), dtype=np.int64)
        if not np.array_equal(got, (ma[i] * mb[i]) % t):
            raise AssertionError(f"row {i} does not decrypt to the product")

    rec = {"phase": "bfv_served", "n": n,
           "coeff_bits": [m.bit_count for m in coeff], "batch": batch,
           "out_shape": list(served.shape), "compile_s": compile_s,
           "memory": _memory(compiled), "bit_exact": True}
    if timed:
        rec["device_ops_per_s"] = batch / time_calls(compiled, (da, db, dk))
    rec["peak_bytes_in_use"] = _peak_bytes()
    return rec


def rotate_many(n=8192, bits=CKKS_BITS, sec=None, batch=16, n_steps=8,
                scale=2.0 ** 40, check=CHECK, timed=True):
    """Hoisted rotations: one mod-up feeds every step's key switch."""
    import jax

    from gemini_seal.devices import time_calls
    from gemini_seal.models.pipelines import build_ckks_rotate_many

    sec = _tc128() if sec is None else sec
    ctx, kg, enc, encoder, dec, ev = _ckks(n, bits, sec)
    steps = list(range(1, n_steps + 1))
    tool = ctx.first_context_data().galois_tool
    elts = [tool.get_elt_from_step(s) for s in steps]
    gk = kg.galois_keys(elts)
    rng = np.random.default_rng(3)
    msgs = [_slot_values(rng, encoder.slot_count) for _ in range(check)]
    cts = [enc.encrypt(encoder.encode(m.tolist(), scale)) for m in msgs]
    host = np.stack([np.asarray(cts[i % check].data) for i in range(batch)])
    dx, dk = jax.device_put(host), jax.device_put(gk.stacked(*elts))
    compiled, compile_s = _aot(build_ckks_rotate_many(ctx, steps), dx, dk)
    out = np.asarray(compiled(dx, dk))      # [n_steps, batch, 2, L, N]
    worst = 0.0
    for i in range(check):
        hoisted = ev.rotate_vector_many(cts[i], steps, gk)
        for j, s in enumerate(steps):
            _equal(out[j, i], hoisted[j].data, f"step {s} row {i}")
        # one mod-up shared by all steps rounds differently from a fresh
        # key switch per step: the same slots, not the same residues
        got = np.asarray(encoder.decode(dec.decrypt(hoisted[-1])))
        want = np.asarray(encoder.decode(dec.decrypt(
            ev.rotate_vector(cts[i], steps[-1], gk))))
        worst = max(worst, float(np.abs(got - want).max()),
                    float(np.abs(got - np.roll(msgs[i], -steps[-1])).max()))
    if not worst < 1e-4:
        raise AssertionError(f"rotated slots off by {worst}")
    rec = {"phase": "rotate_many", "n": n, "bits": list(bits),
           "batch": batch, "steps": steps, "out_shape": list(out.shape),
           "compile_s": compile_s, "memory": _memory(compiled),
           "bit_exact_vs_host_hoisted": True, "max_slot_error": worst}
    if timed:
        per = time_calls(compiled, (dx, dk))
        rec["device_rotations_per_s"] = batch * n_steps / per
    rec["peak_bytes_in_use"] = _peak_bytes()
    return rec


def device_evaluator(n=8192, bits=CKKS_BITS, sec=None, scale=2.0 ** 40,
                     check=CHECK, timed=True):
    """The SEAL-style per-op API: each op one cached compiled program."""
    from gemini_seal.devices import time_calls
    from gemini_seal.models.device_evaluator import DeviceEvaluator

    sec = _tc128() if sec is None else sec
    ctx, kg, enc, encoder, dec, ev = _ckks(n, bits, sec)
    rk = kg.relin_keys()
    rng = np.random.default_rng(4)
    ca = [enc.encrypt(encoder.encode(
        _slot_values(rng, encoder.slot_count).tolist(), scale))
        for _ in range(check)]
    cb = [enc.encrypt(encoder.encode(
        _slot_values(rng, encoder.slot_count).tolist(), scale))
        for _ in range(check)]
    de = DeviceEvaluator(ctx)

    def chain(x, y):
        return de.rescale_to_next(de.relinearize(de.multiply(x, y), rk))

    compile_s = None
    for i in range(check):
        t0 = time.perf_counter()
        got = de.get(chain(de.put(ca[i]), de.put(cb[i])))
        if compile_s is None:
            compile_s = time.perf_counter() - t0
        want = ev.rescale_to_next(ev.relinearize(ev.multiply(ca[i], cb[i]), rk))
        _equal(got.data, want.data, f"chain {i}")
        if got.parms_id != want.parms_id or got.scale != want.scale:
            raise AssertionError(f"chain {i}: metadata differs")
    rec = {"phase": "device_evaluator", "n": n, "bits": list(bits),
           "shape": list(np.asarray(ca[0].data).shape),
           "first_call_s": compile_s, "memory": None, "bit_exact": True}
    if timed:
        x, y = de.put(ca[0]), de.put(cb[0])
        rec["chains_per_s"] = 1.0 / time_calls(lambda: chain(x, y).data, ())
    rec["peak_bytes_in_use"] = _peak_bytes()
    return rec


ONE_CARD = (ckks_served, bfv_served, rotate_many, device_evaluator)


# ---------------------------------------------------------------------------
# four cards: the sharded schedules against one card


def _sharded_case(name, sharded, single, args, single_args, n_devices,
                  timed, rows=None):
    """Compile, compare bit for bit, time and count collectives."""
    import jax

    from gemini_seal.devices import time_calls
    from gemini_seal.parallel.comm import collective_stats

    # both sides time device-resident inputs: no upload inside the timing
    single_args = tuple(jax.device_put(x, jax.devices()[0])
                        for x in single_args)
    compiled, compile_s = _aot(sharded, *args)
    got = np.asarray(compiled(*args))
    want = np.asarray(jax.jit(single)(*single_args))
    if rows is not None:
        got = got[..., :rows, :]
    _equal(got, want, name)
    stats = collective_stats(compiled.as_text())
    rec = {"schedule": name, "devices": n_devices,
           "out_shape": list(want.shape), "compile_s": compile_s,
           "bit_exact": True, "collectives": str(stats),
           "collective_bytes": stats.total_bytes}
    if timed:
        rec["step_s"] = time_calls(compiled, args, min_seconds=1.0)
        rec["single_card_step_s"] = time_calls(
            jax.jit(single), single_args, min_seconds=1.0)
    return rec


def four_cards(n_devices=4, ckks_n=8192, ckks_bits=CKKS_BITS, batch=128,
               csp_batch=32, limb_n=16384,
               limb_bits=(50,) + (40,) * 7 + (50, 50), limb_batch=16,
               bfv_n=8192, bfv_coeff=None, bfv_batch=16, sec=None,
               timed=True):
    """Every multi-device schedule on an ``n_devices`` mesh, bit-exact
    against the same computation on one device."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from gemini_seal import CoeffModulus
    from gemini_seal.models.bootstrap import (
        _collapse_chain, _scale_diagonals, special_fft_stage_diagonals,
    )
    from gemini_seal.models.pipelines import (
        build_bfv_mul_relin, build_ckks_matvec, build_ckks_mul_relin_rescale,
    )
    from gemini_seal.ops.keyswitch import KeySwitchPlan
    from gemini_seal.ops.ntt import ntt_forward
    from gemini_seal.parallel.behz_sp import bfv_mul_relin_limb_sharded
    from gemini_seal.parallel.bootstrap_sp import build_ckks_matvec_limb_sharded
    from gemini_seal.parallel.keyswitch_sp import (
        ckks_mul_relin_rescale_limb_sharded,
    )
    from gemini_seal.parallel.mesh import make_he_mesh
    from gemini_seal.parallel.ntt_sp import (
        ntt_forward_sharded, ntt_forward_sharded_4step,
    )
    from gemini_seal.parallel.pipeline_csp import (
        ckks_mul_relin_rescale_coeff_sharded,
    )

    sec = _tc128() if sec is None else sec
    devices = jax.devices()[:n_devices]
    if len(devices) < n_devices:
        raise SystemExit(f"--four-cards needs {n_devices} devices, "
                         f"JAX sees {len(jax.devices())}")
    recs = []

    # (1) dp-sharded: the CKKS served batch split over the cards
    ctx, kg, enc, encoder, _, _ = _ckks(ckks_n, ckks_bits, sec)
    rk = kg.relin_keys().stacked(2)
    rng = np.random.default_rng(5)
    cts = [np.asarray(enc.encrypt(encoder.encode(
        _slot_values(rng, encoder.slot_count).tolist(), 2.0 ** 40)).data)
        for _ in range(CHECK)]
    a = np.stack([cts[i % CHECK] for i in range(batch)])
    b = np.stack([cts[(i + 1) % CHECK] for i in range(batch)])
    mesh = make_he_mesh(devices=devices, dp=n_devices, limb=1)
    sh = NamedSharding(mesh, P("dp", None, None, None))
    rep = NamedSharding(mesh, P())
    fused = build_ckks_mul_relin_rescale(ctx, fused=True)
    args = (jax.device_put(a, sh), jax.device_put(b, sh),
            jax.device_put(rk, rep))
    recs.append(_sharded_case("dp_ckks_mul_relin_rescale", fused, fused,
                              args, (a, b, rk), n_devices, timed))

    # (2) coefficient-sharded: NTT schedules and the composed step
    cmesh = Mesh(np.asarray(devices), axis_names=("coeff",))
    csh = NamedSharding(cmesh, P(None, None, None, "coeff"))
    tables = ctx.first_context_data().ntt_tables
    ac, bc = a[:csp_batch], b[:csp_batch]
    dac = jax.device_put(ac, csh)
    for tag, fn in (("hypercube_ppermute", ntt_forward_sharded),
                    ("four_step_all_to_all", ntt_forward_sharded_4step)):
        recs.append(_sharded_case(
            f"ntt_sp_{tag}", lambda x, f=fn: f(x, tables, cmesh),
            lambda x: ntt_forward(x, tables), (dac,), (ac,), n_devices,
            timed))
    plan = KeySwitchPlan(ctx, ctx.first_parms_id)
    ksh = NamedSharding(cmesh, P(None, None, None, "coeff"))
    recs.append(_sharded_case(
        "csp_ckks_mul_relin_rescale",
        lambda x, y, k: ckks_mul_relin_rescale_coeff_sharded(x, y, k, plan,
                                                             cmesh),
        build_ckks_mul_relin_rescale(ctx),
        (dac, jax.device_put(bc, csh), jax.device_put(rk, ksh)),
        (ac, bc, rk), n_devices, timed))

    # (3) limb-sharded CKKS: keyswitch_sp step and a bootstrap C2S group
    lctx, lkg, lenc, lencoder, _, _ = _ckks(limb_n, limb_bits, sec, nsp=2)
    lcd = lctx.first_context_data()
    n_ct = len(lcd.parms.coeff_modulus)
    lrk = lkg.relin_keys().stacked(2)
    lcts = [np.asarray(lenc.encrypt(lencoder.encode(
        _slot_values(rng, lencoder.slot_count).tolist(), 2.0 ** 40)).data)
        for _ in range(CHECK)]
    la = np.stack([lcts[i % CHECK] for i in range(limb_batch)])
    lmesh = make_he_mesh(devices=devices, dp=1, limb=n_devices)
    lsh = NamedSharding(lmesh, P(None, None, "limb", None))
    lplan = KeySwitchPlan(lctx, lctx.first_parms_id)
    dla = jax.device_put(la, lsh)
    # the explicit schedules slice the key rows per device on the host
    recs.append(_sharded_case(
        "keyswitch_sp_ckks_mul_relin_rescale",
        lambda x, y: ckks_mul_relin_rescale_limb_sharded(x, y, lrk, lplan,
                                                         lmesh),
        build_ckks_mul_relin_rescale(lctx),
        (dla, dla), (la, la, lrk), n_devices, timed, rows=n_ct - 1))

    _, inv_st = special_fft_stage_diagonals(lencoder)
    groups = _collapse_chain(list(reversed(inv_st)), lencoder.slots, 2)
    diag = _scale_diagonals(groups[0], 0.25 + 0.1j)
    mscale = float(lcd.parms.coeff_modulus[-1].value)
    tool = lcd.galois_tool
    elts = [tool.get_elt_from_step(d) for d in sorted(diag) if d != 0]
    gkeys = np.asarray(lkg.galois_keys(elts).stacked(*elts))
    mv = build_ckks_matvec_limb_sharded(lctx, diag, mscale, lencoder, lmesh)
    one = la[0]
    mv_one = build_ckks_matvec(lctx, diag, mscale, lencoder)
    recs.append(_sharded_case(
        "bootstrap_sp_c2s_matvec", lambda x: mv(x, gkeys), mv_one,
        (jax.device_put(one, NamedSharding(lmesh, P(None, "limb", None))),),
        (one, gkeys), n_devices, timed))

    # (4) limb-sharded BFV: the BEHZ multiply+relinearize
    bcoeff = CoeffModulus.bfv_default(bfv_n) if bfv_coeff is None else bfv_coeff
    bctx, bkg, benc, be, _, _ = _bfv(bfv_n, bcoeff, sec)
    brk = bkg.relin_keys().stacked(2)
    t = bctx.first_context_data().parms.plain_modulus.value
    bcts = [np.asarray(benc.encrypt(be.encode(
        rng.integers(0, t, be.slot_count).tolist())).data)
        for _ in range(CHECK)]
    ba = np.stack([bcts[i % CHECK] for i in range(bfv_batch)])
    bb = np.stack([bcts[(i + 1) % CHECK] for i in range(bfv_batch)])
    bsh = NamedSharding(lmesh, P(None, None, "limb", None))
    recs.append(_sharded_case(
        "behz_sp_bfv_mul_relin",
        lambda x, y: bfv_mul_relin_limb_sharded(x, y, brk, bctx, lmesh),
        build_bfv_mul_relin(bctx),
        (jax.device_put(ba, bsh), jax.device_put(bb, bsh)), (ba, bb, brk),
        n_devices, timed))
    return recs


# ---------------------------------------------------------------------------
# entry point


def last_line(devices) -> str:
    """The final JSON line: only the keys the contract names."""
    from gemini_seal.devices import device_record

    return json.dumps({"ok": True, "device": device_record(devices)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded schedules on a 4-card mesh")
    cfg = ap.parse_args(argv)

    import jax

    from gemini_seal import compile_cache
    from gemini_seal.devices import card_line, require_gpu
    from gemini_seal.utils import native

    require_gpu(jax.default_backend(), "chip_smoke.py")
    compile_cache.enable()
    import jaxlib

    devices = jax.devices()
    print(f"card: {card_line()}")
    print(f"device_kind: {devices[0].device_kind}; devices: {len(devices)}; "
          f"jax {jax.__version__}, jaxlib {jaxlib.__version__}; "
          f"native host module: {native.available()}", flush=True)

    if cfg.four_cards:
        for rec in four_cards():
            print("four_cards " + json.dumps(rec), flush=True)
        devices = devices[:4]
    else:
        for phase in ONE_CARD:
            t0 = time.perf_counter()
            rec = phase()
            rec["phase_s"] = time.perf_counter() - t0
            print("phase " + json.dumps(rec), flush=True)
        devices = devices[:1]
    print(last_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
