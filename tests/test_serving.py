"""EncryptedComputeServer: SEAL-wire blobs in -> jitted pipeline ->
SEAL-wire blobs out, with batch padding to the compiled size."""

import numpy as np
import pytest

from gemini_seal import (
    CKKSEncoder,
    CoeffModulus,
    Decryptor,
    EncryptionParameters,
    Encryptor,
    KeyGenerator,
    SchemeType,
    SecLevelType,
    SealContext,
)
from gemini_seal import serialization as ser
from gemini_seal.models.pipelines import build_ckks_dense_layer
from gemini_seal.models.serving import EncryptedComputeServer

SEED = tuple(range(41, 49))


def test_wire_to_wire_dense_layer():
    parms = EncryptionParameters(SchemeType.CKKS)
    n = 256
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [50, 40, 40, 50]))
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    tool = ctx.first_context_data().galois_tool
    rk = kg.relin_keys()
    scale = 2.0 ** 40
    dim = 4

    rng = np.random.default_rng(3)
    M = rng.uniform(-0.5, 0.5, size=(dim, dim))
    b = rng.uniform(-0.2, 0.2, size=dim)
    slots = encoder.slot_count
    diagonals = {
        d: [M[i % dim, (i + d) % dim] for i in range(slots)] for d in range(dim)
    }
    bias = [b[i % dim] for i in range(slots)]
    steps = sorted(s for s in diagonals if s != 0)
    elts = [tool.get_elt_from_step(s) for s in steps]
    gk = kg.galois_keys(elts)

    layer, out_id, out_scale = build_ckks_dense_layer(
        ctx, diagonals, bias, scale, encoder
    )
    server = EncryptedComputeServer(
        ctx, layer, [gk.stacked(*elts), rk.stacked(2)],
        out_parms_id=out_id, out_is_ntt=True, out_scale=out_scale,
        batch_size=4, compr_mode=ser.COMPR_DEFLATE,
    )

    # three clients, each shipping a wire-format request (batch < compiled)
    xs = [rng.uniform(-1, 1, size=dim) for _ in range(3)]
    blobs = [
        ser.save(enc.encrypt(encoder.encode(
            [x[i % dim] for i in range(slots)], scale)))
        for x in xs
    ]
    outs = server.submit(blobs)
    assert len(outs) == 3
    for x, blob in zip(xs, outs):
        ct = ser.load_ciphertext(blob, ctx)
        got = encoder.decode(dec.decrypt(ct))
        want = (M @ x + b) ** 2
        for g, w in zip(got[:dim], want):
            assert abs(g - w) < 1e-3

    # oversize batch is rejected, empty batch is a no-op
    with pytest.raises(ValueError, match="exceeds compiled"):
        server.submit(blobs * 2)
    assert server.submit([]) == []

    # a tampered blob is rejected at the validation boundary
    bad = bytearray(blobs[0])
    bad[40] ^= 0xFF
    with pytest.raises(Exception):
        server.submit([bytes(bad)])


def test_wire_to_wire_cnn():
    """A full encrypted CNN (conv + square + BSGS dense readout) behind
    the serving endpoint: SEAL blobs in, class scores out."""
    from gemini_seal.models.pipelines import build_ckks_cnn

    parms = EncryptionParameters(SchemeType.CKKS)
    n = 1024
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [50, 40, 40, 40, 50]))
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    tool = ctx.first_context_data().galois_tool
    rk = kg.relin_keys()
    scale = 2.0 ** 40
    h = w = 8
    hw = h * w

    rng = np.random.default_rng(21)
    kern = rng.uniform(-0.4, 0.4, size=(3, 3))
    R = np.zeros((hw, hw))
    for d in (0, 1, 2, 3, 7):
        for i in range(hw):
            R[i, (i + d) % hw] = rng.uniform(-0.3, 0.3)
    slots = encoder.slot_count
    readout = {
        d: [R[i % hw, (i + d) % hw] for i in range(slots)]
        for d in (0, 1, 2, 3, 7)
    }

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

    nst = len(gk_stacks)
    server = EncryptedComputeServer(
        ctx, lambda c, *ka: fn(c, ka[:nst], ka[nst]),
        gk_stacks + [rk.stacked(2)],
        out_parms_id=out_pid, out_is_ntt=True, out_scale=out_scale,
        batch_size=2,
    )

    imgs = [rng.uniform(0, 1, size=(h, w)) for _ in range(2)]
    blobs = [
        ser.save(enc.encrypt(encoder.encode(
            [im.reshape(-1)[i % hw] for i in range(slots)], scale)))
        for im in imgs
    ]
    outs = server.submit(blobs)
    for im, blob in zip(imgs, outs):
        conv = np.zeros((h, w))
        for r in range(h):
            for c in range(w):
                for dy in (-1, 0, 1):
                    for dx in (-1, 0, 1):
                        if 0 <= r + dy < h and 0 <= c + dx < w:
                            conv[r, c] += kern[dy + 1, dx + 1] * im[r + dy, c + dx]
        want = R @ (conv.reshape(-1) ** 2)
        got = encoder.decode(dec.decrypt(ser.load_ciphertext(blob, ctx)))
        for g, t in zip(got[:hw], want):
            assert abs(g - t) < 1e-2, (g, t)


def test_wire_to_wire_matmul_pairs():
    """Two-operand endpoint: (A, B) blob pairs in -> encrypted d x d
    matrix products out (n_inputs=2 stacks one batch per operand)."""
    from gemini_seal.ciphertext import Ciphertext
    from gemini_seal.models.pipelines import build_ckks_matmul_square

    d, n = 4, 32
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [50, 40, 40, 40, 40, 50]))
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    tool = ctx.first_context_data().galois_tool
    scale = 2.0 ** 40

    fn, out_pid, out_scale = build_ckks_matmul_square(ctx, d, scale, encoder)
    elts = [tool.get_elt_from_step(s) for s in fn.rot_steps]
    gk = kg.galois_keys(elts)
    server = EncryptedComputeServer(
        ctx, fn, [gk.stacked(*elts), kg.relin_keys().stacked(2)],
        out_parms_id=out_pid, out_is_ntt=True, out_scale=out_scale,
        batch_size=4, n_inputs=2,
    )

    rng = np.random.default_rng(9)
    mats = [(rng.uniform(-1, 1, (d, d)), rng.uniform(-1, 1, (d, d)))
            for _ in range(3)]
    reqs = [
        (ser.save(enc.encrypt(encoder.encode(A.flatten().tolist(), scale))),
         ser.save(enc.encrypt(encoder.encode(B.flatten().tolist(), scale))))
        for A, B in mats
    ]
    outs = server.submit(reqs)
    assert len(outs) == 3
    for (A, B), blob in zip(mats, outs):
        ct = ser.load_ciphertext(blob, ctx)
        got = np.asarray(encoder.decode(dec.decrypt(ct)))[: d * d]
        want = (A @ B).flatten()
        assert np.abs(got - want).max() < 1e-2

    with pytest.raises(ValueError, match="needs 2 ciphertext"):
        server.submit([(reqs[0][0],)])


def test_multi_operand_rejects_bare_blob():
    """A bare bytes blob on an n_inputs=2 server must be rejected with an
    actionable error (not exploded into per-byte ints by tuple())."""
    from gemini_seal.models.pipelines import build_ckks_matmul_square

    d, n = 4, 32
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [50, 40, 40, 40, 40, 50]))
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    tool = ctx.first_context_data().galois_tool
    fn, out_pid, out_scale = build_ckks_matmul_square(ctx, d, 2.0 ** 40,
                                                      encoder)
    elts = [tool.get_elt_from_step(s) for s in fn.rot_steps]
    gk = kg.galois_keys(elts)
    server = EncryptedComputeServer(
        ctx, fn, [gk.stacked(*elts), kg.relin_keys().stacked(2)],
        out_parms_id=out_pid, out_is_ntt=True, out_scale=out_scale,
        batch_size=2, n_inputs=2,
    )
    blob = ser.save(enc.encrypt(encoder.encode([0.5] * (d * d), 2.0 ** 40)))
    with pytest.raises(ValueError, match="pass tuples"):
        server.submit([blob])
    with pytest.raises(ValueError, match="pass tuples"):
        server.warm(blob)


def test_submit_stream_matches_submit():
    """Pipelined submit_stream yields exactly per-batch submit()'s blobs
    (double-buffered upload/compute changes scheduling, not values)."""
    parms = EncryptionParameters(SchemeType.CKKS)
    n = 256
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [50, 40, 40, 50]))
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    tool = ctx.first_context_data().galois_tool
    rk = kg.relin_keys()
    scale = 2.0 ** 40
    dim = 4

    rng = np.random.default_rng(11)
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
        batch_size=3)

    batches = []
    for k in range(3):
        xs = [rng.uniform(-1, 1, size=dim) for _ in range(2 + k % 2)]
        batches.append([
            ser.save(enc.encrypt(encoder.encode(
                [x[i % dim] for i in range(slots)], scale)))
            for x in xs
        ])
    want = [server.submit(bl) for bl in batches]
    got = list(server.submit_stream(batches))
    assert got == want

    # empty inner batches are skipped, order preserved
    got2 = list(server.submit_stream([batches[0], [], batches[1]]))
    assert got2 == [want[0], want[1]]
