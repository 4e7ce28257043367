"""Jitted device pipelines must be bit-exact against the eager host
evaluator (the numpy plane) — the same op functions trace to jax under jit
via ops.backend dispatch, so any divergence is a backend-semantics bug.

No analogue in the reference (its only execution mode is eager C++);
closest is the evaluator round-trip suite (tests/seal/evaluator.cpp).
"""

import numpy as np
import pytest

from gemini_seal import (
    CKKSEncoder,
    BatchEncoder,
    CoeffModulus,
    Decryptor,
    EncryptionParameters,
    Encryptor,
    Evaluator,
    KeyGenerator,
    PlainModulus,
    SchemeType,
    SecLevelType,
    SealContext,
)
from gemini_seal.models.pipelines import (
    build_bfv_mul_relin,
    build_ckks_mul_relin_rescale,
    build_ckks_rotate,
    build_ckks_train_step,
)

SEED = tuple(range(11, 19))


def ckks_setup(n=256, bits=(40, 30, 40)):
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, list(bits)))
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    return ctx, kg


def test_ckks_mul_relin_rescale_matches_host():
    import jax

    ctx, kg = ckks_setup()
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    ev = Evaluator(ctx)
    rk = kg.relin_keys()
    scale = 2.0 ** 30

    ct_a = enc.encrypt(encoder.encode([0.5, -1.0, 2.0], scale))
    ct_b = enc.encrypt(encoder.encode([1.5, 0.25, -0.5], scale))

    host = ev.rescale_to_next(ev.relinearize(ev.multiply(ct_a, ct_b), rk))

    rk_data = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
    step = jax.jit(build_ckks_mul_relin_rescale(ctx))
    dev = np.asarray(step(np.asarray(ct_a.data), np.asarray(ct_b.data), rk_data))

    np.testing.assert_array_equal(dev, np.asarray(host.data))


def test_ckks_mul_relin_rescale_batched():
    import jax

    ctx, kg = ckks_setup()
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    ev = Evaluator(ctx)
    rk = kg.relin_keys()
    scale = 2.0 ** 30

    cts = [
        enc.encrypt(encoder.encode([float(i) / 4, -float(i)], scale))
        for i in range(3)
    ]
    hosts = [
        ev.rescale_to_next(ev.relinearize(ev.multiply(ct, ct), rk)) for ct in cts
    ]

    rk_data = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
    batch = np.stack([np.asarray(ct.data) for ct in cts])
    step = jax.jit(build_ckks_mul_relin_rescale(ctx))
    dev = np.asarray(step(batch, batch, rk_data))

    for i, host in enumerate(hosts):
        np.testing.assert_array_equal(dev[i], np.asarray(host.data))


def test_ckks_rotate_matches_host():
    import jax

    ctx, kg = ckks_setup()
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    ev = Evaluator(ctx)
    tool = ctx.first_context_data().galois_tool
    elt = tool.get_elt_from_step(1)
    gk = kg.galois_keys([elt])
    scale = 2.0 ** 30

    ct = enc.encrypt(encoder.encode([0.5, -1.0, 2.0, 3.5], scale))
    host = ev.rotate_vector(ct, 1, gk)

    gk_data = np.stack([np.asarray(pk.data.data) for pk in gk.key(elt)])
    step = jax.jit(build_ckks_rotate(ctx, 1))
    dev = np.asarray(step(np.asarray(ct.data), gk_data))

    np.testing.assert_array_equal(dev, np.asarray(host.data))


def test_bfv_mul_relin_matches_host():
    import jax

    n = 64
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [40, 40, 40]))
    parms.set_plain_modulus(PlainModulus.batching(n, 20))
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    be = BatchEncoder(ctx)
    ev = Evaluator(ctx)
    rk = kg.relin_keys()

    ct_a = enc.encrypt(be.encode(list(range(n))))
    ct_b = enc.encrypt(be.encode([3] * n))
    host = ev.relinearize(ev.multiply(ct_a, ct_b), rk)

    rk_data = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
    step = jax.jit(build_bfv_mul_relin(ctx))
    dev = np.asarray(step(np.asarray(ct_a.data), np.asarray(ct_b.data), rk_data))

    np.testing.assert_array_equal(dev, np.asarray(host.data))

    # and it decrypts to the product
    dec = Decryptor(ctx, kg.secret_key)
    from gemini_seal.ciphertext import Ciphertext

    out = be.decode(
        dec.decrypt(Ciphertext(dev, host.parms_id, False, host.scale))
    )
    assert out[:n] == [3 * i for i in range(n)]


def test_ckks_train_step_decrypts():
    import jax

    ctx, kg = ckks_setup()
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    tool = ctx.first_context_data().galois_tool
    elt = tool.get_elt_from_step(1)
    rk = kg.relin_keys()
    gk = kg.galois_keys([elt])
    scale = 2.0 ** 30

    vals = [0.5, -1.25, 2.0, 0.0]
    ct = enc.encrypt(encoder.encode(vals, scale))
    rk_data = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
    gk_data = np.stack([np.asarray(pk.data.data) for pk in gk.key(elt)])

    step = jax.jit(build_ckks_train_step(ctx, rotate_steps=1))
    out = np.asarray(step(np.asarray(ct.data), np.asarray(ct.data), rk_data, gk_data))

    from gemini_seal.ciphertext import Ciphertext

    next_id = ctx.first_context_data().next_context_data.parms_id
    # step computes sq + rot(sq): expected slot i = v_i^2 + v_{i+1}^2
    # (slots beyond the encoded values are zero, so no wraparound terms)
    sq = [v * v for v in vals]
    expect = [sq[i] + (sq[i + 1] if i + 1 < len(vals) else 0.0)
              for i in range(len(vals))]
    # the true post-rescale scale comes from the host evaluator
    ev = Evaluator(ctx)
    prod = ev.rescale_to_next(ev.relinearize(ev.multiply(
        enc.encrypt(encoder.encode(vals, scale)),
        enc.encrypt(encoder.encode(vals, scale))), rk))
    ct2 = Ciphertext(out, next_id, True, prod.scale)
    got = encoder.decode(dec.decrypt(ct2))
    for g, e in zip(got[: len(vals)], expect):
        assert abs(g - e) < 1e-3, (got[: len(vals)], expect)


def test_hoisted_rotate_many():
    """Hoisted multi-rotation decrypts to the same plaintext as individual
    rotations (values differ only in absorbed lift noise)."""
    import jax

    ctx, kg = ckks_setup()
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    ev = Evaluator(ctx)
    tool = ctx.first_context_data().galois_tool
    steps = [1, 2, 5]
    elts = tool.get_elts_from_steps(steps)
    gk = kg.galois_keys(elts)
    scale = 2.0 ** 30

    vals = [0.5, -1.25, 2.0, 3.5, -0.75, 1.0, 0.25, -2.0]
    ct = enc.encrypt(encoder.encode(vals, scale))

    # host evaluator API
    outs = ev.rotate_vector_many(ct, steps, gk)
    for s, out in zip(steps, outs):
        want = encoder.decode(dec.decrypt(ev.rotate_vector(ct, s, gk)))
        got = encoder.decode(dec.decrypt(out))
        for g, w in zip(got[: len(vals)], want[: len(vals)]):
            assert abs(g - w) < 1e-4, (s, got[:4], want[:4])

    # jitted pipeline
    from gemini_seal.models.pipelines import build_ckks_rotate_many

    keys_stack = np.stack([
        np.stack([np.asarray(pk.data.data) for pk in gk.key(elt)])
        for elt in elts
    ])
    step = jax.jit(build_ckks_rotate_many(ctx, steps))
    dev = np.asarray(step(np.asarray(ct.data), keys_stack))
    for i, host_out in enumerate(outs):
        np.testing.assert_array_equal(dev[i], np.asarray(host_out.data))


def test_hoisted_rotate_rows_bfv():
    n = 64
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [40, 40, 40]))
    parms.set_plain_modulus(PlainModulus.batching(n, 20))
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    be = BatchEncoder(ctx)
    ev = Evaluator(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    tool = ctx.first_context_data().galois_tool
    steps = [1, 3, -2]
    gk = kg.galois_keys(tool.get_elts_from_steps(steps))

    vals = list(range(n))
    ct = enc.encrypt(be.encode(vals))
    outs = ev.rotate_rows_many(ct, steps, gk)
    for s, out in zip(steps, outs):
        want = be.decode(dec.decrypt(ev.rotate_rows(ct, s, gk)))
        got = be.decode(dec.decrypt(out))
        assert got == want, s


def test_deep_poly_eval():
    """Config-5-style deep pipeline: degree-4 polynomial, 3 levels of
    mult+relin+rescale, plaintext linear combination, one rotation-sum."""
    import jax
    from gemini_seal.models.pipelines import build_ckks_poly_eval

    parms = EncryptionParameters(SchemeType.CKKS)
    n = 512
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [59, 30, 30, 30, 59]))
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    tool = ctx.first_context_data().galois_tool
    rk = kg.relin_keys()
    elts = [tool.get_elt_from_step(1)]
    gk = kg.galois_keys(elts)

    coeffs = [1.0, -0.5, 0.25, 0.125, 0.0625]  # degree 4
    scale = 2.0 ** 30  # stabilized against the 30-bit chain primes
    step, deep_id, out_scale = build_ckks_poly_eval(
        ctx, coeffs, scale, encoder, rotate_sum_log2=1,
        coeff_precision_bits=25,
    )

    vals = [0.5, -0.8, 0.3, 1.1]
    ct = enc.encrypt(encoder.encode(vals, scale))
    rk_data = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
    gk_stack = np.stack([
        np.stack([np.asarray(pk.data.data) for pk in gk.key(e)]) for e in elts
    ])

    out = np.asarray(jax.jit(step)(np.asarray(ct.data), rk_data, gk_stack))

    from gemini_seal.ciphertext import Ciphertext

    got = encoder.decode(dec.decrypt(Ciphertext(out, deep_id, True, out_scale)))

    def p(x):
        return sum(c * x ** k for k, c in enumerate(coeffs))

    padded = vals + [0.0]
    expect = [p(padded[i]) + p(padded[i + 1]) for i in range(len(vals))]
    for g, e in zip(got[: len(vals)], expect):
        assert abs(g - e) < 1e-3, (got[: len(vals)], expect)

    # composed=True (per-level jitted programs, the production deep-circuit
    # mode) must be bit-identical to the monolithic graph
    run, deep_id2, out_scale2 = build_ckks_poly_eval(
        ctx, coeffs, scale, encoder, rotate_sum_log2=1,
        coeff_precision_bits=25, composed=True,
    )
    assert deep_id2 == deep_id and out_scale2 == out_scale
    out_composed = np.asarray(run(np.asarray(ct.data), rk_data, gk_stack))
    np.testing.assert_array_equal(out_composed, out)

    # rotate_mode="flat" (hoisted raw-sum, ONE mod-up + ONE mod-down):
    # with rotate_sum_log2=1 the key set coincides (step 1 only); results
    # decrypt equal to the tree within sub-noise rounding
    stepf, deep_idf, out_scalef = build_ckks_poly_eval(
        ctx, coeffs, scale, encoder, rotate_sum_log2=1,
        coeff_precision_bits=25, rotate_mode="flat",
    )
    outf = np.asarray(jax.jit(stepf)(np.asarray(ct.data), rk_data, gk_stack))
    gotf = encoder.decode(dec.decrypt(Ciphertext(outf, deep_idf, True, out_scalef)))
    for g, e in zip(gotf[: len(vals)], expect):
        assert abs(g - e) < 1e-3, (gotf[: len(vals)], expect)
    for g, gt in zip(gotf[:8], got[:8]):
        assert abs(g - gt) < 1e-5, (g, gt)

    # flat with m=2: sums 4 adjacent slots, needs keys for steps 1..3
    elts3 = [tool.get_elt_from_step(s) for s in (1, 2, 3)]
    gk3 = kg.galois_keys(elts3)
    gk3_stack = np.stack([
        np.stack([np.asarray(pk.data.data) for pk in gk3.key(e)]) for e in elts3
    ])
    step2, deep_id2f, out_scale2f = build_ckks_poly_eval(
        ctx, coeffs, scale, encoder, rotate_sum_log2=2,
        coeff_precision_bits=25, rotate_mode="flat",
    )
    out2 = np.asarray(jax.jit(step2)(np.asarray(ct.data), rk_data, gk3_stack))
    got2 = encoder.decode(dec.decrypt(Ciphertext(out2, deep_id2f, True, out_scale2f)))
    padded2 = vals + [0.0] * 3
    expect2 = [sum(p(padded2[i + j]) for j in range(4)) for i in range(len(vals))]
    for g, e in zip(got2[: len(vals)], expect2):
        assert abs(g - e) < 1e-3, (got2[: len(vals)], expect2)


def test_multi_special_prime_pipeline():
    """nsp=3 hybrid key-switch through the jitted pipeline is bit-exact vs
    the host evaluator (the fork's headline configuration, ex4 pattern)."""
    import jax

    parms = EncryptionParameters(SchemeType.CKKS)
    n = 256
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [40, 30, 30, 40, 40, 40]))
    parms.set_n_special_primes(3)
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    assert ctx.first_context_data().parms.n_special_primes == 3
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    ev = Evaluator(ctx)
    rk = kg.relin_keys()
    scale = 2.0 ** 30

    v = [0.5, -1.25, 3.0]
    ct = enc.encrypt(encoder.encode(v, scale))
    host = ev.rescale_to_next(ev.relinearize(ev.multiply(ct, ct), rk))

    rk_data = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
    step = jax.jit(build_ckks_mul_relin_rescale(ctx))
    dev = np.asarray(step(np.asarray(ct.data), np.asarray(ct.data), rk_data))
    np.testing.assert_array_equal(dev, np.asarray(host.data))

    got = encoder.decode(dec.decrypt(host))
    assert all(abs(g - x * x) < 1e-4 for g, x in zip(got[:3], v))


def test_fused_rescale_decrypts_equal():
    """The fused P*q_last mod-down decrypts to the same values as the
    sequential relinearize+rescale pipeline (bounded sub-noise rounding
    difference only)."""
    import jax

    ctx, kg = ckks_setup()
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    rk = kg.relin_keys()
    scale = 2.0 ** 30

    vals = [0.5, -1.0, 2.0, 0.25]
    ct = enc.encrypt(encoder.encode(vals, scale))
    rk_data = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])

    from gemini_seal.models.pipelines import build_ckks_mul_relin_rescale
    from gemini_seal.ciphertext import Ciphertext

    seq = jax.jit(build_ckks_mul_relin_rescale(ctx))
    fus = jax.jit(build_ckks_mul_relin_rescale(ctx, fused=True))
    a = np.asarray(ct.data)
    out_seq = np.asarray(seq(a, a, rk_data))
    out_fus = np.asarray(fus(a, a, rk_data))
    assert out_seq.shape == out_fus.shape

    next_id = ctx.first_context_data().next_context_data.parms_id
    q_last = ctx.first_context_data().parms.coeff_modulus[-1].value
    s2 = scale * scale / q_last
    got_seq = encoder.decode(dec.decrypt(Ciphertext(out_seq, next_id, True, s2)))
    got_fus = encoder.decode(dec.decrypt(Ciphertext(out_fus, next_id, True, s2)))
    for gs, gf, v in zip(got_seq[:4], got_fus[:4], vals):
        assert abs(gf - v * v) < 1e-4, (gf, v * v)
        assert abs(gs - gf) < 1e-5, (gs, gf)


def test_hoisted_matvec():
    """Diagonal-method encrypted matvec with hoisted rotations computes
    M @ x (slot-wise) correctly."""
    import jax
    from gemini_seal.models.pipelines import build_ckks_matvec
    from gemini_seal.ciphertext import Ciphertext

    ctx, kg = ckks_setup(n=256, bits=(50, 40, 50))
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    tool = ctx.first_context_data().galois_tool
    scale = 2.0 ** 40

    # 4x4 matrix over the first 4 slots (wrap within the slot vector is
    # avoided by padding the input periodically)
    rng = np.random.default_rng(3)
    M = rng.uniform(-1, 1, size=(4, 4))
    x = rng.uniform(-1, 1, size=4)
    slots = encoder.slot_count
    # periodic extension so rot(x, d) wraps correctly for the 4x4 block
    x_slots = [x[i % 4] for i in range(slots)]

    diagonals = {}
    for d in range(4):
        diag = [M[i % 4, (i + d) % 4] for i in range(slots)]
        diagonals[d] = diag

    steps = sorted(s for s in diagonals if s != 0)
    elts = [tool.get_elt_from_step(s) for s in steps]
    gk = kg.galois_keys(elts)
    gk_stack = np.stack([
        np.stack([np.asarray(pk.data.data) for pk in gk.key(e)]) for e in elts
    ])

    ct = enc.encrypt(encoder.encode(x_slots, scale))
    want = M @ x
    results = {}
    for fuse in (False, True):
        fn = jax.jit(build_ckks_matvec(ctx, diagonals, scale, encoder,
                                       fuse_moddown=fuse))
        out = np.asarray(fn(np.asarray(ct.data), gk_stack))
        got = encoder.decode(dec.decrypt(
            Ciphertext(out, ct.parms_id, True, scale * scale)
        ))
        results[fuse] = got
        for i in range(4):
            assert abs(got[i] - want[i]) < 1e-4, (fuse, i, got[i], want[i])
    # the fused single mod-down's interpolation rounding stays sub-noise
    for a, b in zip(results[False][:8], results[True][:8]):
        assert abs(a - b) < 1e-5, (a, b)


def bfv_setup(n=64, bits=(40, 40, 40, 40), t=257):
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, list(bits)))
    parms.set_plain_modulus(t)
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    return ctx, KeyGenerator(ctx)


def test_bfv_mul_relin_modswitch_pipeline():
    """The fused BFV config-3 pipeline: exact-chain mode is bit-exact vs
    the host evaluator; fused multi-drop mode decrypts identically."""
    import jax
    from gemini_seal import Plaintext
    from gemini_seal.ciphertext import Ciphertext
    from gemini_seal.models.pipelines import build_bfv_mul_relin_modswitch

    ctx, kg = bfv_setup()
    enc = Encryptor(ctx, public_key=kg.public_key())
    dec = Decryptor(ctx, kg.secret_key)
    ev = Evaluator(ctx)
    rk = kg.relin_keys()
    rk_data = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
    ct = enc.encrypt(Plaintext.from_hex("3x^2 + 2"))
    a = np.asarray(ct.data)
    last = ctx.last_parms_id

    want_ct = ev.mod_switch_to(ev.relinearize(ev.multiply(ct, ct), rk), last)

    exact = jax.jit(build_bfv_mul_relin_modswitch(ctx, fused_drop=False))
    out = np.asarray(exact(a, a, rk_data))
    np.testing.assert_array_equal(out, np.asarray(want_ct.data))

    fused = jax.jit(build_bfv_mul_relin_modswitch(ctx, fused_drop=True))
    out_f = np.asarray(fused(a, a, rk_data))
    got = dec.decrypt(Ciphertext(out_f, last, False, 1.0))
    assert got.to_hex() == dec.decrypt(want_ct).to_hex()

    # square variant: bit-exact vs the multiply pipeline on (a, a)
    sq = jax.jit(build_bfv_mul_relin_modswitch(ctx, fused_drop=False, square=True))
    np.testing.assert_array_equal(np.asarray(sq(a, rk_data)), out)


def test_bfv_rotate_many_hoisted_matches_host():
    import jax
    from gemini_seal.models.pipelines import build_bfv_rotate_many

    ctx, kg = bfv_setup(t=PlainModulus.batching(64, 20).value)
    enc = Encryptor(ctx, public_key=kg.public_key())
    dec = Decryptor(ctx, kg.secret_key)
    ev = Evaluator(ctx)
    be = BatchEncoder(ctx)
    steps = [1, 2, 3]
    tool = ctx.first_context_data().galois_tool
    elts = tool.get_elts_from_steps(steps)
    gk = kg.galois_keys(elts)

    ct = enc.encrypt(be.encode(list(range(be.slot_count))))
    host = ev.rotate_rows_many(ct, steps, gk)

    gk_stack = np.stack([
        np.stack([np.asarray(pk.data.data) for pk in gk.key(e)]) for e in elts
    ])
    step = jax.jit(build_bfv_rotate_many(ctx, steps))
    out = np.asarray(step(np.asarray(ct.data), gk_stack))
    for i, h in enumerate(host):
        np.testing.assert_array_equal(out[i], np.asarray(h.data))


def test_fused_dense_layer():
    """build_ckks_dense_layer: one jitted program computing
    act(M @ x + b) == the eager ex9 flow (matvec, rescale, bias, square)."""
    import jax
    from gemini_seal.ciphertext import Ciphertext
    from gemini_seal.models.pipelines import build_ckks_dense_layer

    ctx, kg = ckks_setup(n=256, bits=(50, 40, 40, 50))
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    tool = ctx.first_context_data().galois_tool
    rk = kg.relin_keys()
    scale = 2.0 ** 40
    dim = 4

    rng = np.random.default_rng(7)
    M = rng.uniform(-0.5, 0.5, size=(dim, dim))
    b = rng.uniform(-0.2, 0.2, size=dim)
    x = rng.uniform(-1, 1, size=dim)
    slots = encoder.slot_count
    x_slots = [x[i % dim] for i in range(slots)]
    diagonals = {
        d: [M[i % dim, (i + d) % dim] for i in range(slots)] for d in range(dim)
    }
    bias = [b[i % dim] for i in range(slots)]
    steps = sorted(s for s in diagonals if s != 0)
    elts = [tool.get_elt_from_step(s) for s in steps]
    gk = kg.galois_keys(elts)
    gk_stack = np.stack([
        np.stack([np.asarray(pk.data.data) for pk in gk.key(e)]) for e in elts
    ])
    rk_data = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
    ct = enc.encrypt(encoder.encode(x_slots, scale))

    fn, out_id, out_scale = build_ckks_dense_layer(
        ctx, diagonals, bias, scale, encoder
    )
    out = np.asarray(jax.jit(fn)(np.asarray(ct.data), gk_stack, rk_data))
    got = encoder.decode(dec.decrypt(Ciphertext(out, out_id, True, out_scale)))
    want = (M @ x + b) ** 2
    for g, w in zip(got[:dim], want):
        assert abs(g - w) < 1e-3, (got[:dim], want)

    # linear variant (activation=None)
    fnl, out_idl, out_scalel = build_ckks_dense_layer(
        ctx, diagonals, bias, scale, encoder, activation=None
    )
    outl = np.asarray(jax.jit(fnl)(np.asarray(ct.data), gk_stack, rk_data))
    gotl = encoder.decode(dec.decrypt(Ciphertext(outl, out_idl, True, out_scalel)))
    wantl = M @ x + b
    for g, w in zip(gotl[:dim], wantl):
        assert abs(g - w) < 1e-3, (gotl[:dim], wantl)


def test_bfv_hoisted_matvec():
    """BFV diagonal-method matvec (hoisted, single fused mod-down)
    decrypts to M @ x over the slot rows, matching the eager
    rotate/multiply_plain/add composition."""
    import jax
    from gemini_seal.ciphertext import Ciphertext
    from gemini_seal.models.pipelines import build_bfv_matvec

    n = 64
    t = PlainModulus.batching(n, 17)
    ctx, kg = bfv_setup(n=n, bits=(40, 40, 40, 40), t=t.value)
    enc = Encryptor(ctx, public_key=kg.public_key())
    be = BatchEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    ev = Evaluator(ctx)
    tool = ctx.first_context_data().galois_tool

    dim = 4
    rng = np.random.default_rng(5)
    M = rng.integers(0, 7, size=(dim, dim))
    x = rng.integers(0, 7, size=dim)
    row = n // 2
    # periodic extension within each batching row so row-rotations wrap
    x_slots = [int(x[i % dim]) for i in range(n)]
    diagonals = {
        d: [int(M[i % dim, (i + d) % dim]) for i in range(n)]
        for d in range(dim)
    }
    steps = sorted(s for s in diagonals if s != 0)
    elts = [tool.get_elt_from_step(s) for s in steps]
    gk = kg.galois_keys(elts)
    gk_stack = np.stack([
        np.stack([np.asarray(pk.data.data) for pk in gk.key(e)]) for e in elts
    ])
    ct = enc.encrypt(be.encode(x_slots))

    # eager reference composition
    want_acc = None
    for s in sorted(diagonals):
        term = ev.multiply_plain(
            ev.rotate_rows(ct, s, gk) if s else ct, be.encode(diagonals[s])
        )
        want_acc = term if want_acc is None else ev.add(want_acc, term)
    want = be.decode(dec.decrypt(want_acc))

    fn = jax.jit(build_bfv_matvec(ctx, diagonals, be))
    out = np.asarray(fn(np.asarray(ct.data), gk_stack))
    got = be.decode(dec.decrypt(
        Ciphertext(out, ct.parms_id, False, 1.0)
    ))
    assert got == want
    expect = [int((M @ x)[i % dim]) % t.value for i in range(dim)]
    assert got[:dim] == expect, (got[:dim], expect)


def test_ckks_mlp_two_layers():
    """Two chained dense layers (square activation then linear) as one
    program: y = M2 @ (act(M1 @ x + b1)) + b2."""
    import jax
    from gemini_seal.ciphertext import Ciphertext
    from gemini_seal.models.pipelines import build_ckks_mlp

    ctx, kg = ckks_setup(n=512, bits=(50, 40, 40, 40, 50))
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    tool = ctx.first_context_data().galois_tool
    rk = kg.relin_keys()
    scale = 2.0 ** 40
    dim = 4

    rng = np.random.default_rng(9)
    M1 = rng.uniform(-0.5, 0.5, size=(dim, dim))
    b1 = rng.uniform(-0.2, 0.2, size=dim)
    M2 = rng.uniform(-0.5, 0.5, size=(dim, dim))
    b2 = rng.uniform(-0.2, 0.2, size=dim)
    x = rng.uniform(-1, 1, size=dim)
    slots = encoder.slot_count

    def diag(M):
        return {d: [M[i % dim, (i + d) % dim] for i in range(slots)]
                for d in range(dim)}

    def bias(b):
        return [b[i % dim] for i in range(slots)]

    layers = [(diag(M1), bias(b1), "square"), (diag(M2), bias(b2), None)]
    all_steps = sorted(s for s in range(dim) if s != 0)
    elts = [tool.get_elt_from_step(s) for s in all_steps]
    gk = kg.galois_keys(elts)
    gk_stack = np.stack([
        np.stack([np.asarray(pk.data.data) for pk in gk.key(e)]) for e in elts
    ])
    rk_data = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
    ct = enc.encrypt(encoder.encode([x[i % dim] for i in range(slots)], scale))

    fn, out_id, out_scale = build_ckks_mlp(ctx, layers, scale, encoder)
    out = np.asarray(jax.jit(
        lambda c, g, k: fn(c, [g, g], k)
    )(np.asarray(ct.data), gk_stack, rk_data))
    got = encoder.decode(dec.decrypt(Ciphertext(out, out_id, True, out_scale)))
    want = M2 @ ((M1 @ x + b1) ** 2) + b2
    for g, w in zip(got[:dim], want):
        assert abs(g - w) < 1e-2, (got[:dim], want)


def test_stacked_key_helper():
    """KSwitchKeys.stacked() matches the hand-built np.stack pattern used
    by every pipeline harness."""
    ctx, kg = ckks_setup()
    rk = kg.relin_keys()
    tool = ctx.first_context_data().galois_tool
    elts = tool.get_elts_from_steps([1, 2])
    gk = kg.galois_keys(elts)

    want_rk = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
    np.testing.assert_array_equal(rk.stacked(2), want_rk)

    want_gk = np.stack([
        np.stack([np.asarray(pk.data.data) for pk in gk.key(e)]) for e in elts
    ])
    np.testing.assert_array_equal(gk.stacked(*elts), want_gk)


def test_decrypt_batch_matches_per_ct():
    """Decryptor.decrypt_batch over a [B, size, L, N] tensor equals
    per-ciphertext decrypt for both schemes."""
    # CKKS
    ctx, kg = ckks_setup()
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    scale = 2.0 ** 30
    cts = [enc.encrypt(encoder.encode([float(i), -0.5 * i], scale))
           for i in range(3)]
    batch = np.stack([np.asarray(ct.data) for ct in cts])
    outs = dec.decrypt_batch(batch, cts[0].parms_id, True, scale)
    for ct, pt in zip(cts, outs):
        want = dec.decrypt(ct)
        np.testing.assert_array_equal(np.asarray(pt.data), np.asarray(want.data))
        assert encoder.decode(pt) == encoder.decode(want)

    # BFV
    bctx, bkg = bfv_setup(n=64, t=257)
    benc = Encryptor(bctx, public_key=bkg.public_key())
    bdec = Decryptor(bctx, bkg.secret_key)
    from gemini_seal import Plaintext
    bcts = [benc.encrypt(Plaintext.from_hex(h)) for h in ("3x^2 + 2", "5x^1 + 7", "1")]
    bbatch = np.stack([np.asarray(ct.data) for ct in bcts])
    bouts = bdec.decrypt_batch(bbatch, bcts[0].parms_id, False)
    for ct, pt in zip(bcts, bouts):
        assert pt.to_hex() == bdec.decrypt(ct).to_hex()


def test_ckks_conv2d():
    """build_ckks_conv2d: SAME-padding conv over a slot-packed image ==
    numpy direct convolution (masked diagonals turn the cyclic slot
    rotation into true zero padding)."""
    import jax
    from gemini_seal.ciphertext import Ciphertext
    from gemini_seal.models.pipelines import build_ckks_conv2d

    ctx, kg = ckks_setup(n=256, bits=(50, 40, 40, 50))
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    tool = ctx.first_context_data().galois_tool
    rk = kg.relin_keys()
    scale = 2.0 ** 40
    h, w = 5, 6

    rng = np.random.default_rng(3)
    img = rng.uniform(-1, 1, size=(h, w))
    k = rng.uniform(-0.5, 0.5, size=(3, 3))
    b = rng.uniform(-0.2, 0.2, size=h * w)

    want = np.zeros((h, w))
    for r in range(h):
        for c in range(w):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if 0 <= r + dy < h and 0 <= c + dx < w:
                        want[r, c] += k[dy + 1, dx + 1] * img[r + dy, c + dx]
    want = want.reshape(-1) + b

    slots = encoder.slot_count
    x_slots = np.zeros(slots)
    x_slots[: h * w] = img.reshape(-1)
    ct = enc.encrypt(encoder.encode(x_slots.tolist(), scale))

    fn, out_id, out_scale, rot_steps = build_ckks_conv2d(
        ctx, k, h, w, scale, encoder, bias=b.tolist(), activation=None
    )
    elts = [tool.get_elt_from_step(s) for s in rot_steps]
    gk = kg.galois_keys(elts)
    gk_stack = gk.stacked(*elts)
    rk_data = rk.stacked(2)

    out = np.asarray(jax.jit(fn)(np.asarray(ct.data), gk_stack, rk_data))
    got = encoder.decode(dec.decrypt(Ciphertext(out, out_id, True, out_scale)))
    for g, t in zip(got[: h * w], want):
        assert abs(g - t) < 1e-3, (got[: h * w], want)

    # square activation variant
    fns, out_ids, out_scales, _ = build_ckks_conv2d(
        ctx, k, h, w, scale, encoder, bias=b.tolist(), activation="square"
    )
    outs = np.asarray(jax.jit(fns)(np.asarray(ct.data), gk_stack, rk_data))
    gots = encoder.decode(
        dec.decrypt(Ciphertext(outs, out_ids, True, out_scales))
    )
    for g, t in zip(gots[: h * w], want ** 2):
        assert abs(g - t) < 1e-3, (gots[: h * w], want ** 2)


def test_ckks_logreg():
    """build_ckks_logreg: encrypted sigmoid(w . x + b) head matches the
    plain degree-3 approximation 0.5 + 0.197 z - 0.004 z^3."""
    import jax
    from gemini_seal.ciphertext import Ciphertext
    from gemini_seal.models.pipelines import build_ckks_logreg

    ctx, kg = ckks_setup(n=256, bits=(50, 40, 40, 40, 40, 50))
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    tool = ctx.first_context_data().galois_tool
    rk = kg.relin_keys()
    scale = 2.0 ** 40

    rng = np.random.default_rng(11)
    F = 4
    wts = rng.uniform(-0.5, 0.5, size=F)
    x = rng.uniform(-1, 1, size=F)
    intercept = 0.3
    z = float(wts @ x + intercept)
    want = 0.5 + 0.197 * z - 0.004 * z ** 3

    fn, out_id, out_scale, rot_steps = build_ckks_logreg(
        ctx, wts.tolist(), intercept, scale, encoder
    )
    elts = [tool.get_elt_from_step(s) for s in rot_steps]
    gk = kg.galois_keys(elts)
    gk_stack = gk.stacked(*elts)
    rk_data = rk.stacked(2)

    slots = encoder.slot_count
    x_slots = np.zeros(slots)
    x_slots[:F] = x
    ct = enc.encrypt(encoder.encode(x_slots.tolist(), scale))
    out = np.asarray(jax.jit(fn)(np.asarray(ct.data), gk_stack, rk_data))
    got = encoder.decode(dec.decrypt(Ciphertext(out, out_id, True, out_scale)))
    assert abs(got[0] - want) < 1e-2, (got[0], want, z)


def test_bsgs_matvec():
    """Baby-step/giant-step matvec == flat hoisted matvec == M @ x (the
    BSGS regrouping rot_{gB}(rot(diag,-gB) (*) rot(x,b)) must reproduce
    the diagonal method exactly up to the fused mod-down's sub-noise
    interpolation rounding)."""
    import jax
    from gemini_seal.ciphertext import Ciphertext
    from gemini_seal.models.pipelines import (build_ckks_matvec,
                                                  build_ckks_matvec_bsgs)

    ctx, kg = ckks_setup(n=512, bits=(50, 40, 50))
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    tool = ctx.first_context_data().galois_tool
    scale = 2.0 ** 40
    k = 16

    rng = np.random.default_rng(7)
    M = rng.uniform(-1, 1, size=(k, k))
    x = rng.uniform(-1, 1, size=k)
    slots = encoder.slot_count
    x_slots = [x[i % k] for i in range(slots)]
    diagonals = {
        d: [M[i % k, (i + d) % k] for i in range(slots)] for d in range(k)
    }
    want = M @ x

    ct = enc.encrypt(encoder.encode(x_slots, scale))

    fn, rot_steps = build_ckks_matvec_bsgs(ctx, diagonals, scale, encoder)
    # B = ceil(sqrt(16)) = 4: 3 baby + 3 giant rotations vs 15 flat
    assert rot_steps == [1, 2, 3, 4, 8, 12], rot_steps
    elts = [tool.get_elt_from_step(s) for s in rot_steps]
    gk = kg.galois_keys(elts)
    out = np.asarray(
        jax.jit(fn)(np.asarray(ct.data), gk.stacked(*elts))
    )
    got = encoder.decode(
        dec.decrypt(Ciphertext(out, ct.parms_id, True, scale * scale))
    )
    for i in range(k):
        assert abs(got[i] - want[i]) < 1e-3, (i, got[i], want[i])

    # flat hoisted path on the same inputs agrees closely (both decrypt
    # to M @ x; they differ only by mod-down rounding placement)
    flat_steps = sorted(s for s in diagonals if s != 0)
    flat_elts = [tool.get_elt_from_step(s) for s in flat_steps]
    gk_flat = kg.galois_keys(flat_elts)
    flat = jax.jit(build_ckks_matvec(ctx, diagonals, scale, encoder))
    out_f = np.asarray(
        flat(np.asarray(ct.data), gk_flat.stacked(*flat_elts))
    )
    got_f = encoder.decode(
        dec.decrypt(Ciphertext(out_f, ct.parms_id, True, scale * scale))
    )
    for a, b in zip(got[:k], got_f[:k]):
        assert abs(a - b) < 1e-4


def test_bsgs_matvec_sparse_groups():
    """BSGS with a sparse diagonal set (missing baby/giant combinations,
    no step-0 diagonal) still computes the right linear map."""
    import jax
    from gemini_seal.ciphertext import Ciphertext
    from gemini_seal.models.pipelines import build_ckks_matvec_bsgs

    ctx, kg = ckks_setup(n=512, bits=(50, 40, 50))
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    tool = ctx.first_context_data().galois_tool
    scale = 2.0 ** 40
    n_block = 16

    rng = np.random.default_rng(17)
    keep = [1, 2, 5, 7, 11, 14]          # no 0, giant group 2 sparse
    M = np.zeros((n_block, n_block))
    for d in keep:
        for i in range(n_block):
            M[i, (i + d) % n_block] = rng.uniform(-1, 1)
    x = rng.uniform(-1, 1, size=n_block)
    slots = encoder.slot_count
    x_slots = [x[i % n_block] for i in range(slots)]
    diagonals = {
        d: [M[i % n_block, (i + d) % n_block] for i in range(slots)]
        for d in keep
    }
    want = M @ x

    ct = enc.encrypt(encoder.encode(x_slots, scale))
    fn, rot_steps = build_ckks_matvec_bsgs(ctx, diagonals, scale, encoder,
                                           baby=4)
    elts = [tool.get_elt_from_step(s) for s in rot_steps]
    gk = kg.galois_keys(elts)
    out = np.asarray(jax.jit(fn)(np.asarray(ct.data), gk.stacked(*elts)))
    got = encoder.decode(
        dec.decrypt(Ciphertext(out, ct.parms_id, True, scale * scale))
    )
    for i in range(n_block):
        assert abs(got[i] - want[i]) < 1e-3, (i, got[i], want[i])


def test_ckks_cnn():
    """build_ckks_cnn: conv(3x3)+square then BSGS dense+square then linear
    readout — the whole encrypted CNN as one program matches the numpy
    forward pass."""
    import jax
    from gemini_seal.ciphertext import Ciphertext
    from gemini_seal.models.pipelines import build_ckks_cnn

    ctx, kg = ckks_setup(
        n=1024, bits=(50, 40, 40, 40, 40, 40, 40, 50)
    )
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    tool = ctx.first_context_data().galois_tool
    rk = kg.relin_keys()
    scale = 2.0 ** 40
    h, w = 8, 8
    hw = h * w

    rng = np.random.default_rng(5)
    img = rng.uniform(-0.5, 0.5, size=(h, w))
    k1 = rng.uniform(-0.5, 0.5, size=(3, 3))
    cb = rng.uniform(-0.1, 0.1, size=hw)
    dense_steps = [0, 1, 2, 3, 5, 9, 17]      # sparse 64x64 over the block
    M = np.zeros((hw, hw))
    for d in dense_steps:
        for i in range(hw):
            M[i, (i + d) % hw] = rng.uniform(-0.2, 0.2)
    db = rng.uniform(-0.1, 0.1, size=hw)
    R = np.zeros((hw, hw))               # linear readout, 3 diagonals
    for d in (0, 1, 2):
        for i in range(hw):
            R[i, (i + d) % hw] = rng.uniform(-0.3, 0.3)

    # numpy forward pass (wrap-around semantics within the hw block for
    # the dense layers; zero-padded SAME conv for the conv layer)
    conv = np.zeros((h, w))
    for r in range(h):
        for c in range(w):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if 0 <= r + dy < h and 0 <= c + dx < w:
                        conv[r, c] += k1[dy + 1, dx + 1] * img[r + dy, c + dx]
    a1 = (conv.reshape(-1) + cb) ** 2
    a2 = (M @ a1 + db) ** 2
    want = R @ a2

    slots = encoder.slot_count
    x = np.zeros(slots)
    x[:hw] = img.reshape(-1)
    # dense layers wrap cyclically over the FULL slot vector, so extend
    # the block periodically (pipelines' diagonal-method contract)
    diagonals = {
        d: [M[i % hw, (i + d) % hw] for i in range(slots)]
        for d in dense_steps
    }
    readout = {
        d: [R[i % hw, (i + d) % hw] for i in range(slots)] for d in (0, 1, 2)
    }
    # block-periodic input so slot-vector rotations match block wraps:
    x_per = np.zeros(slots)
    x_per[:] = [img.reshape(-1)[i % hw] for i in range(slots)]
    db_per = [db[i % hw] for i in range(slots)]
    cb_per = [cb[i % hw] for i in range(slots)]

    fn, out_pid, out_scale = build_ckks_cnn(
        ctx,
        convs=[(k1, cb_per, "square")],
        dense=[(diagonals, db_per, "square"),
               (readout, [0.0] * slots, None)],
        height=h, width=w, scale=scale, encoder=encoder, bsgs=True,
    )
    # conv flat steps; dense layers on the BSGS schedule
    # B=3: babies {1,2}, giant groups {3,9,15}
    assert fn.rot_steps[1] == [1, 2, 3, 9, 15], fn.rot_steps[1]

    gk_stacks = []
    for layer_steps in fn.rot_steps:
        elts = [tool.get_elt_from_step(s) for s in layer_steps]
        gk = kg.galois_keys(elts)
        gk_stacks.append(gk.stacked(*elts))

    ct = enc.encrypt(encoder.encode(x_per.tolist(), scale))
    out = np.asarray(
        jax.jit(lambda c, g0, g1, g2, r: fn(c, (g0, g1, g2), r))(
            np.asarray(ct.data), *gk_stacks, rk.stacked(2)
        )
    )
    got = encoder.decode(dec.decrypt(Ciphertext(out, out_pid, True, out_scale)))
    for i in range(hw):
        assert abs(got[i] - want[i]) < 2e-2, (i, got[i], want[i])


def test_ckks_conv2d_multichannel():
    """Multi-channel conv [oc=2, ic=2, 3, 3] over channels-blocked slots
    == numpy conv per (oc, ic) pair summed, with zero padding."""
    import jax
    from gemini_seal.ciphertext import Ciphertext
    from gemini_seal.models.pipelines import build_ckks_conv2d_mc

    ctx, kg = ckks_setup(n=512, bits=(50, 40, 50))
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    tool = ctx.first_context_data().galois_tool
    rk = kg.relin_keys()
    scale = 2.0 ** 40
    h, w, IC, OC = 6, 6, 2, 2
    hw = h * w

    rng = np.random.default_rng(9)
    img = rng.uniform(-1, 1, size=(IC, h, w))
    K = rng.uniform(-0.4, 0.4, size=(OC, IC, 3, 3))
    b = rng.uniform(-0.1, 0.1, size=OC * hw)

    want = np.zeros((OC, h, w))
    for oc in range(OC):
        for ic in range(IC):
            for r in range(h):
                for c in range(w):
                    for dy in (-1, 0, 1):
                        for dx in (-1, 0, 1):
                            if 0 <= r + dy < h and 0 <= c + dx < w:
                                want[oc, r, c] += (K[oc, ic, dy + 1, dx + 1]
                                                   * img[ic, r + dy, c + dx])
    want = want.reshape(-1) + b

    slots = encoder.slot_count
    x = np.zeros(slots)
    x[:IC * hw] = img.reshape(-1)
    ct = enc.encrypt(encoder.encode(x.tolist(), scale))

    fn, out_id, out_scale, rot_steps = build_ckks_conv2d_mc(
        ctx, K, h, w, scale, encoder, bias=b.tolist()
    )
    elts = [tool.get_elt_from_step(s) for s in rot_steps]
    gk = kg.galois_keys(elts)
    out = np.asarray(
        jax.jit(fn)(np.asarray(ct.data), gk.stacked(*elts), rk.stacked(2))
    )
    got = encoder.decode(dec.decrypt(Ciphertext(out, out_id, True, out_scale)))
    for i in range(OC * hw):
        assert abs(got[i] - want[i]) < 1e-3, (i, got[i], want[i])


def test_ckks_cnn_multichannel():
    """CNN with a 1->2 channel conv then a dense readout over the blocked
    output matches numpy (periodic chaining with oc > ic)."""
    import jax
    from gemini_seal.ciphertext import Ciphertext
    from gemini_seal.models.pipelines import build_ckks_cnn

    ctx, kg = ckks_setup(n=1024, bits=(50, 40, 40, 40, 50))
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    tool = ctx.first_context_data().galois_tool
    rk = kg.relin_keys()
    scale = 2.0 ** 40
    h = w = 4
    hw = h * w
    OC = 2
    blk = OC * hw

    rng = np.random.default_rng(13)
    img = rng.uniform(-0.5, 0.5, size=(h, w))
    K = rng.uniform(-0.4, 0.4, size=(OC, 1, 3, 3))
    # readout over the blocked conv output (blk x blk band)
    R = np.zeros((blk, blk))
    for d in (0, 1, 5):
        for i in range(blk):
            R[i, (i + d) % blk] = rng.uniform(-0.3, 0.3)

    conv = np.zeros((OC, h, w))
    for oc in range(OC):
        for r in range(h):
            for c in range(w):
                for dy in (-1, 0, 1):
                    for dx in (-1, 0, 1):
                        if 0 <= r + dy < h and 0 <= c + dx < w:
                            conv[oc, r, c] += (K[oc, 0, dy + 1, dx + 1]
                                               * img[r + dy, c + dx])
    a1 = conv.reshape(-1) ** 2
    want = R @ a1

    slots = encoder.slot_count
    readout = {
        d: [R[i % blk, (i + d) % blk] for i in range(slots)] for d in (0, 1, 5)
    }
    fn, out_pid, out_scale = build_ckks_cnn(
        ctx,
        convs=[(K, None, "square")],
        dense=[(readout, [0.0] * slots, None)],
        height=h, width=w, scale=scale, encoder=encoder, bsgs=True,
    )
    gk_stacks = []
    for layer_steps in fn.rot_steps:
        elts = [tool.get_elt_from_step(s) for s in layer_steps]
        gk = kg.galois_keys(elts)
        gk_stacks.append(gk.stacked(*elts))

    # ic=1 input: periodic over hw (oc % ic == 0 chaining contract)
    x_per = [img.reshape(-1)[i % hw] for i in range(slots)]
    ct = enc.encrypt(encoder.encode(x_per, scale))
    out = np.asarray(
        jax.jit(lambda c, g0, g1, r: fn(c, (g0, g1), r))(
            np.asarray(ct.data), *gk_stacks, rk.stacked(2)
        )
    )
    got = encoder.decode(dec.decrypt(Ciphertext(out, out_pid, True, out_scale)))
    for i in range(blk):
        assert abs(got[i] - want[i]) < 2e-2, (i, got[i], want[i])


def test_strided_dense_readout():
    """conv + square then a stride-2 dense readout built by
    strided_dense_diagonals (pooling absorbed into the readout's
    diagonals, negative-equivalent steps normalized for BSGS)."""
    import jax
    from gemini_seal.ciphertext import Ciphertext
    from gemini_seal.models.pipelines import (build_ckks_cnn,
                                                  strided_dense_diagonals)

    ctx, kg = ckks_setup(n=1024, bits=(50, 40, 40, 40, 50))
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    tool = ctx.first_context_data().galois_tool
    rk = kg.relin_keys()
    scale = 2.0 ** 40
    h = w = 8
    hw = h * w
    stride = 2
    ph = pw = h // stride
    n_out = 10

    rng = np.random.default_rng(31)
    img = rng.uniform(-0.5, 0.5, size=(h, w))
    kern = rng.uniform(-0.4, 0.4, size=(3, 3))
    D = rng.uniform(-0.3, 0.3, size=(n_out, ph * pw))

    conv = np.zeros((h, w))
    for r in range(h):
        for c in range(w):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if 0 <= r + dy < h and 0 <= c + dx < w:
                        conv[r, c] += kern[dy + 1, dx + 1] * img[r + dy, c + dx]
    a1 = conv ** 2
    pooled = a1[::stride, ::stride].reshape(-1)     # strided subsample
    want = D @ pooled

    slots = encoder.slot_count
    readout = strided_dense_diagonals(D, h, w, stride, slots)
    fn, out_pid, out_scale = build_ckks_cnn(
        ctx, convs=[(kern, None, "square")],
        dense=[(readout, [0.0] * slots, None)],
        height=h, width=w, scale=scale, encoder=encoder, bsgs=True,
    )
    gk_stacks = []
    for layer_steps in fn.rot_steps:
        elts = [tool.get_elt_from_step(s) for s in layer_steps]
        gk = kg.galois_keys(elts)
        gk_stacks.append(gk.stacked(*elts))

    x_per = [img.reshape(-1)[i % hw] for i in range(slots)]
    ct = enc.encrypt(encoder.encode(x_per, scale))
    out = np.asarray(
        jax.jit(lambda c, g0, g1, r: fn(c, (g0, g1), r))(
            np.asarray(ct.data), *gk_stacks, rk.stacked(2)
        )
    )
    got = encoder.decode(dec.decrypt(Ciphertext(out, out_pid, True, out_scale)))
    for i in range(n_out):
        assert abs(got[i] - want[i]) < 1e-2, (i, got[i], want[i])


def test_ckks_logreg_train_step():
    """One encrypted logistic-regression GD iteration (X and w both
    encrypted) == the numpy update with the degree-3 sigmoid, and the
    output w' is replicated per block at the input scale (self-similar)."""
    import jax
    from gemini_seal.ciphertext import Ciphertext
    from gemini_seal.models.pipelines import build_ckks_logreg_train_step

    ctx, kg = ckks_setup(n=512, bits=(50,) + (40,) * 7 + (50,))
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    tool = ctx.first_context_data().galois_tool
    rk = kg.relin_keys()
    scale = 2.0 ** 40
    m, F = 8, 4
    Bf = 4

    rng = np.random.default_rng(19)
    X = rng.uniform(-1, 1, size=(m, F))
    y = rng.integers(0, 2, size=m).astype(float)
    w = rng.uniform(-0.5, 0.5, size=F)
    alpha = 0.1

    z = X @ w
    sig = 0.5 + 0.197 * z - 0.004 * z ** 3
    want = w - alpha * (X.T @ (sig - y))

    slots = encoder.slot_count
    x_slots = np.zeros(slots)
    for i in range(m):
        x_slots[i * Bf:i * Bf + F] = X[i]
    w_slots = np.zeros(slots)
    for i in range(slots // Bf):
        w_slots[i * Bf:i * Bf + F] = w

    fn, out_pid, out_scale, rot_steps = build_ckks_logreg_train_step(
        ctx, m, F, y.tolist(), alpha, scale, encoder)
    assert out_scale == scale          # self-similar
    elts = [tool.get_elt_from_step(s) for s in rot_steps]
    gk = kg.galois_keys(elts)

    ct_x = enc.encrypt(encoder.encode(x_slots.tolist(), scale))
    ct_w = enc.encrypt(encoder.encode(w_slots.tolist(), scale))
    out = np.asarray(jax.jit(fn)(
        np.asarray(ct_x.data), np.asarray(ct_w.data),
        gk.stacked(*elts), rk.stacked(2)))
    got = encoder.decode(dec.decrypt(Ciphertext(out, out_pid, True, out_scale)))

    for blk in (0, 1, m - 1):          # replicated across the m' blocks
        for j in range(F):
            g = got[blk * Bf + j]
            assert abs(g - want[j]) < 1e-2, (blk, j, g, want[j])


def test_ckks_matmul_square():
    """Encrypted d x d matrix product (JKLS sigma/tau/shift schedule)
    decrypts to A @ B; the whole product is one jitted program consuming
    3 levels."""
    import jax
    from gemini_seal.ciphertext import Ciphertext
    from gemini_seal.models.pipelines import build_ckks_matmul_square

    d = 4
    n = 2 * d * d                       # slots = d^2
    ctx, kg = ckks_setup(n=n, bits=(50, 40, 40, 40, 40, 50))
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    tool = ctx.first_context_data().galois_tool
    scale = 2.0 ** 40

    fn, out_pid, out_scale = build_ckks_matmul_square(ctx, d, scale, encoder)
    # 3(d-1) distinct rotations: +-k column shifts and k*d row shifts
    assert len(fn.rot_steps) == 3 * (d - 1), fn.rot_steps
    elts = [tool.get_elt_from_step(s) for s in fn.rot_steps]
    gk = kg.galois_keys(elts)
    gk_stack = gk.stacked(*elts)
    rk = kg.relin_keys().stacked(2)

    rng = np.random.default_rng(11)
    A = rng.uniform(-1, 1, size=(d, d))
    B = rng.uniform(-1, 1, size=(d, d))
    ctA = enc.encrypt(encoder.encode(A.flatten().tolist(), scale))
    ctB = enc.encrypt(encoder.encode(B.flatten().tolist(), scale))

    out = np.asarray(
        jax.jit(fn)(np.asarray(ctA.data), np.asarray(ctB.data), gk_stack, rk)
    )
    got = np.asarray(encoder.decode(
        dec.decrypt(Ciphertext(out, out_pid, True, out_scale))
    ))[: d * d].reshape(d, d)
    want = A @ B
    assert np.abs(got - want).max() < 1e-2, (got, want)

    # level accounting: output sits exactly 3 levels below the input
    L_in = len(ctx.get_context_data(ctx.first_parms_id).parms.coeff_modulus)
    L_out = len(ctx.get_context_data(out_pid).parms.coeff_modulus)
    assert L_in - L_out == 3

    # batching: a stacked pair of products in one dispatch, rows match
    A2 = rng.uniform(-1, 1, size=(d, d))
    B2 = rng.uniform(-1, 1, size=(d, d))
    ctA2 = enc.encrypt(encoder.encode(A2.flatten().tolist(), scale))
    ctB2 = enc.encrypt(encoder.encode(B2.flatten().tolist(), scale))
    a_b = np.stack([np.asarray(ctA.data), np.asarray(ctA2.data)])
    b_b = np.stack([np.asarray(ctB.data), np.asarray(ctB2.data)])
    out_b = np.asarray(jax.jit(fn)(a_b, b_b, gk_stack, rk))
    np.testing.assert_array_equal(out_b[0], out)
    got2 = np.asarray(encoder.decode(
        dec.decrypt(Ciphertext(out_b[1], out_pid, True, out_scale))
    ))[: d * d].reshape(d, d)
    assert np.abs(got2 - A2 @ B2).max() < 1e-2


def test_ckks_matmul_square_multihead():
    """heads=4 independent d x d products packed as contiguous d^2-slot
    blocks in ONE ciphertext: the block-masked JKLS schedule (tau/psi row
    wraps split into in-block + one-block-lower rotations) decrypts to
    every head's A_h @ B_h, still 3 levels."""
    import jax
    from gemini_seal.ciphertext import Ciphertext
    from gemini_seal.models.pipelines import build_ckks_matmul_square

    d, H = 4, 4
    n = 2 * H * d * d                   # slots = H * d^2
    ctx, kg = ckks_setup(n=n, bits=(50, 40, 40, 40, 40, 50))
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    tool = ctx.first_context_data().galois_tool
    scale = 2.0 ** 40

    fn, out_pid, out_scale = build_ckks_matmul_square(ctx, d, scale, encoder,
                                                      heads=H)
    elts = [tool.get_elt_from_step(s) for s in fn.rot_steps]
    gk = kg.galois_keys(elts)
    gk_stack = gk.stacked(*elts)
    rk = kg.relin_keys().stacked(2)

    rng = np.random.default_rng(29)
    A = rng.uniform(-1, 1, size=(H, d, d))
    B = rng.uniform(-1, 1, size=(H, d, d))
    ctA = enc.encrypt(encoder.encode(A.reshape(-1).tolist(), scale))
    ctB = enc.encrypt(encoder.encode(B.reshape(-1).tolist(), scale))
    out = np.asarray(
        jax.jit(fn)(np.asarray(ctA.data), np.asarray(ctB.data), gk_stack, rk)
    )
    got = np.asarray(encoder.decode(
        dec.decrypt(Ciphertext(out, out_pid, True, out_scale))
    ))[: H * d * d].reshape(H, d, d)
    want = A @ B                         # batched per-head product
    assert np.abs(got - want).max() < 1e-2
    L_in = len(ctx.get_context_data(ctx.first_parms_id).parms.coeff_modulus)
    L_out = len(ctx.get_context_data(out_pid).parms.coeff_modulus)
    assert L_in - L_out == 3


def test_ckks_inverse():
    """Goldschmidt reciprocal: x_m ~ 1/a with quadratic convergence for
    slot values in (0, 2); one level per iteration."""
    import jax
    from gemini_seal.ciphertext import Ciphertext
    from gemini_seal.models.pipelines import build_ckks_inverse

    ctx, kg = ckks_setup(n=256, bits=(50, 40, 40, 40, 40, 50))
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    scale = 2.0 ** 40
    rk = kg.relin_keys().stacked(2)

    iters = 3
    fn, out_pid, out_scale = build_ckks_inverse(ctx, scale, encoder,
                                                iters=iters)
    rng = np.random.default_rng(17)
    vals = rng.uniform(0.4, 1.6, encoder.slot_count)
    ct = enc.encrypt(encoder.encode(vals.tolist(), scale))
    out = np.asarray(jax.jit(fn)(np.asarray(ct.data), rk))
    got = np.asarray(encoder.decode(
        dec.decrypt(Ciphertext(out, out_pid, True, out_scale))
    ))
    want = 1.0 / vals
    rel = np.abs(got[: len(vals)] - want) / want
    # |1-a|^(2^(iters+1)) <= 0.6^16 ~ 2.8e-4 plus encode noise
    assert rel.max() < 2e-3, rel.max()

    # level accounting: staggered e/x chains -> iters + 1 levels
    L_in = len(ctx.get_context_data(ctx.first_parms_id).parms.coeff_modulus)
    L_out = len(ctx.get_context_data(out_pid).parms.coeff_modulus)
    assert L_in - L_out == iters + 1


def test_ckks_sign_and_relu():
    """Composite-minimax sign and the ReLU gate built on it: encrypted
    outputs match the plain composite curve (the approximation target)
    and the true sign/ReLU outside the resolution gap."""
    import jax
    from gemini_seal.ciphertext import Ciphertext
    from gemini_seal.models.pipelines import (
        build_ckks_relu, build_ckks_sign, sign_composite_reference)

    bits = (50,) + (40,) * 13 + (50,)
    ctx, kg = ckks_setup(n=256, bits=bits)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    scale = 2.0 ** 40
    rk = kg.relin_keys().stacked(2)

    rng = np.random.default_rng(19)
    s_cnt = encoder.slot_count
    vals = rng.uniform(-1, 1, s_cnt)
    vals[0], vals[1] = 0.15, -0.15          # pinned gap-edge probes
    ct = enc.encrypt(encoder.encode(vals.tolist(), scale))

    fn, pid, osc = build_ckks_sign(ctx, scale, encoder)
    out = np.asarray(jax.jit(fn)(np.asarray(ct.data), rk))
    got = np.asarray(encoder.decode(
        dec.decrypt(Ciphertext(out, pid, True, osc))))[:s_cnt]
    # 1) encrypted == plain composite curve (everywhere, incl. the gap)
    curve = sign_composite_reference(vals)
    assert np.abs(got - curve).max() < 1e-2, np.abs(got - curve).max()
    # 2) == true sign outside the documented |a| >= 0.1 gap
    m = np.abs(vals) >= 0.1
    assert np.abs(got[m] - np.sign(vals[m])).max() < 2e-2

    fnr, pidr, oscr = build_ckks_relu(ctx, scale, encoder)
    outr = np.asarray(jax.jit(fnr)(np.asarray(ct.data), rk))
    gotr = np.asarray(encoder.decode(
        dec.decrypt(Ciphertext(outr, pidr, True, oscr))))[:s_cnt]
    want_r = vals * (1 + curve) / 2
    assert np.abs(gotr - want_r).max() < 1e-2
    m = np.abs(vals) >= 0.1
    assert np.abs(gotr[m] - np.maximum(vals[m], 0)).max() < 2e-2


def test_ckks_max():
    """Encrypted slotwise max(a, b): both branches land on one scale
    (ones-plaintext trick), result matches np.maximum outside the sign
    gap and stays between a and b inside it."""
    import jax
    from gemini_seal.ciphertext import Ciphertext
    from gemini_seal.models.pipelines import build_ckks_max

    bits = (50,) + (40,) * 13 + (50,)
    ctx, kg = ckks_setup(n=256, bits=bits)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    scale = 2.0 ** 40
    rk = kg.relin_keys().stacked(2)

    fn, pid, osc = build_ckks_max(ctx, scale, encoder)
    rng = np.random.default_rng(23)
    s_cnt = encoder.slot_count
    a = rng.uniform(-0.5, 0.5, s_cnt)
    b = rng.uniform(-0.5, 0.5, s_cnt)
    ct_a = enc.encrypt(encoder.encode(a.tolist(), scale))
    ct_b = enc.encrypt(encoder.encode(b.tolist(), scale))
    out = np.asarray(jax.jit(fn)(np.asarray(ct_a.data),
                                 np.asarray(ct_b.data), rk))
    got = np.asarray(encoder.decode(
        dec.decrypt(Ciphertext(out, pid, True, osc))))[:s_cnt]
    m = np.abs(a - b) >= 0.1
    assert np.abs(got[m] - np.maximum(a, b)[m]).max() < 2e-2
    # inside the gap the result is sandwiched between min and max
    g = ~m
    assert (got[g] >= np.minimum(a, b)[g] - 1e-2).all()
    assert (got[g] <= np.maximum(a, b)[g] + 1e-2).all()


def test_ckks_rsqrt_and_sqrt():
    """Newton inverse square root and sqrt(a) = a * rsqrt(a): quadratic
    convergence on (0, 2), 4 levels per iteration + 1 for the sqrt."""
    import jax
    from gemini_seal.ciphertext import Ciphertext
    from gemini_seal.models.pipelines import (build_ckks_rsqrt,
                                                  build_ckks_sqrt)

    bits = (50,) + (40,) * 14 + (50,)
    ctx, kg = ckks_setup(n=256, bits=bits)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    scale = 2.0 ** 40
    rk = kg.relin_keys().stacked(2)

    rng = np.random.default_rng(29)
    vals = rng.uniform(0.5, 1.5, encoder.slot_count)
    ct = enc.encrypt(encoder.encode(vals.tolist(), scale))

    fn, pid, osc = build_ckks_rsqrt(ctx, scale, encoder, iters=3)
    out = np.asarray(jax.jit(fn)(np.asarray(ct.data), rk))
    got = np.asarray(encoder.decode(
        dec.decrypt(Ciphertext(out, pid, True, osc))))[: len(vals)]
    rel = np.abs(got * np.sqrt(vals) - 1.0)
    assert rel.max() < 2e-3, rel.max()

    fns, pids, oscs = build_ckks_sqrt(ctx, scale, encoder, iters=3)
    outs = np.asarray(jax.jit(fns)(np.asarray(ct.data), rk))
    gots = np.asarray(encoder.decode(
        dec.decrypt(Ciphertext(outs, pids, True, oscs))))[: len(vals)]
    rels = np.abs(gots / np.sqrt(vals) - 1.0)
    assert rels.max() < 2e-3, rels.max()

    L_in = len(ctx.get_context_data(ctx.first_parms_id).parms.coeff_modulus)
    assert L_in - len(ctx.get_context_data(pid).parms.coeff_modulus) == 12
    assert L_in - len(ctx.get_context_data(pids).parms.coeff_modulus) == 13


def test_ckks_rotate_many_prepermuted_keys_decrypt_equal():
    """Counter-rotated keys (prepermute_galois_stack): shared unpermuted
    digit contraction + one final NTT-domain output permutation decrypts
    to the same slots as the default hoisted path (not bit-identical:
    the mod-down base-conversion lift is not odd-symmetric)."""
    import jax
    from gemini_seal.ciphertext import Ciphertext
    from gemini_seal.models.pipelines import (
        build_ckks_rotate_many, prepermute_galois_stack)

    ctx, kg = ckks_setup()
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    tool = ctx.first_context_data().galois_tool
    steps = [1, 2, 5]
    elts = tool.get_elts_from_steps(steps)
    gk = kg.galois_keys(elts)
    scale = 2.0 ** 30
    vals = [0.5, -1.25, 2.0, 3.5, -0.75, 1.0, 0.25, -2.0]
    ct = enc.encrypt(encoder.encode(vals, scale))
    keys_stack = np.stack([
        np.stack([np.asarray(pk.data.data) for pk in gk.key(e)])
        for e in elts
    ])

    want = np.asarray(jax.jit(build_ckks_rotate_many(ctx, steps))(
        np.asarray(ct.data), keys_stack))
    pk_stack = prepermute_galois_stack(tool, elts, keys_stack)
    got = np.asarray(jax.jit(
        build_ckks_rotate_many(ctx, steps, prepermuted_keys=True))(
        np.asarray(ct.data), pk_stack))

    assert got.shape == want.shape
    pid = ctx.first_parms_id
    for i in range(len(steps)):
        a = encoder.decode(dec.decrypt(Ciphertext(got[i], pid, True, scale)))
        b = encoder.decode(dec.decrypt(Ciphertext(want[i], pid, True, scale)))
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-5


def test_bfv_rotate_many_prepermuted_keys_decrypt_equal():
    """BFV variant: the final signed coeff-domain permutation reproduces
    the default hoisted path's exact decrypted slots."""
    import jax
    from gemini_seal.ciphertext import Ciphertext
    from gemini_seal.models.pipelines import (
        build_bfv_rotate_many, prepermute_galois_stack)

    ctx, kg = bfv_setup(t=PlainModulus.batching(64, 20).value)
    enc = Encryptor(ctx, public_key=kg.public_key())
    dec = Decryptor(ctx, kg.secret_key)
    be = BatchEncoder(ctx)
    tool = ctx.first_context_data().galois_tool
    steps = [1, 2, 3, -2]
    elts = tool.get_elts_from_steps(steps)
    gk = kg.galois_keys(elts)
    ct = enc.encrypt(be.encode(list(range(be.slot_count))))
    keys_stack = np.stack([
        np.stack([np.asarray(pk.data.data) for pk in gk.key(e)])
        for e in elts
    ])
    # batch axis included: the output permutation must broadcast over it
    data = np.broadcast_to(np.asarray(ct.data),
                           (2,) + np.asarray(ct.data).shape)

    want = np.asarray(jax.jit(build_bfv_rotate_many(ctx, steps))(
        data, keys_stack))
    pk_stack = prepermute_galois_stack(tool, elts, keys_stack)
    got = np.asarray(jax.jit(
        build_bfv_rotate_many(ctx, steps, prepermuted_keys=True))(
        data, pk_stack))

    pid = ctx.first_parms_id
    for i in range(len(steps)):
        for bi in range(2):
            a = be.decode(dec.decrypt(Ciphertext(got[i, bi], pid, False, 1.0)))
            b = be.decode(dec.decrypt(Ciphertext(want[i, bi], pid, False,
                                                 1.0)))
            assert list(a) == list(b)
