"""Encrypted single-head attention (build_ckks_attention): Q, K^T, V all
encrypted; softmax(Q K^T / sqrt(d)) @ V decrypts to the numpy attention
within the composed approximation budget (Chebyshev/Taylor exp +
Goldschmidt reciprocal).  No reference analogue at any layer."""

import math

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
    SealContext,
    SecLevelType,
)
from gemini_seal.ciphertext import Ciphertext
from gemini_seal.models.pipelines import attention_plan, build_ckks_attention

_RIGS = {}


def _rig(d, msg_bound=0.5, exp_mode="cheby", iters=None):
    """Build (once per config) a context + attention pipeline + keys."""
    key = (d, msg_bound, exp_mode, iters)
    if key in _RIGS:
        return _RIGS[key]
    n = 2 * d * d
    n_levels, _, _ = attention_plan(d, msg_bound, 4, iters)
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(
        CoeffModulus.create(n, [50] + [40] * n_levels + [50]))
    parms.set_random_seed(tuple(range(11, 19)))
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    scale = 2.0 ** 40
    run, out_pid, out_scale, rot_steps = build_ckks_attention(
        ctx, d, scale, encoder, msg_bound=msg_bound, iters=iters,
        exp_mode=exp_mode)
    tool = ctx.first_context_data().galois_tool
    elts = [tool.get_elt_from_step(st) for st in rot_steps]
    gk = kg.galois_keys(elts)
    rot_stack = gk.stacked(*elts)
    rks = kg.relin_keys().stacked(2)
    rig = (ctx, enc, encoder, dec, scale, run, out_pid, out_scale,
           rot_stack, rks)
    _RIGS[key] = rig
    return rig


def _run_one(rig, Q, K, V, d):
    ctx, enc, encoder, dec, scale, run, out_pid, out_scale, rot_stack, \
        rks = rig

    def pack(M):
        return enc.encrypt(encoder.encode(M.reshape(-1).tolist(), scale))

    ctQ, ctKT, ctV = pack(Q), pack(K.T), pack(V)
    out = np.asarray(run(np.asarray(ctQ.data), np.asarray(ctKT.data),
                         np.asarray(ctV.data), rot_stack, rks))
    got = np.asarray(encoder.decode(dec.decrypt(
        Ciphertext(out, out_pid, True, out_scale))))[: d * d].reshape(d, d)
    S = Q @ K.T / np.sqrt(d)
    P = np.exp(S) / np.exp(S).sum(axis=1, keepdims=True)
    return got, P @ V


def test_attention_plan():
    # legacy shape: deg-4 exp => n_levels == 14 + iters when iters is given
    nl, it, B = attention_plan(4, 0.5, 4, 4)
    assert (nl, it) == (18, 4)
    assert abs(B - 0.5) < 1e-12
    # auto iters satisfies the documented tanh(B) contract, minimally
    for d, mb in [(4, 0.5), (16, 0.5), (32, 0.5), (16, 0.7)]:
        nl, it, B = attention_plan(d, mb)
        e0 = math.tanh(B)
        assert e0 ** (2 ** (it + 1)) <= 1e-5
        assert it == 1 or e0 ** (2 ** it) > 1e-5
        assert nl == 14 + it


def test_encrypted_attention_matches_numpy():
    d = 4
    rig = _rig(d, iters=4)
    rng = np.random.default_rng(23)
    Q = rng.uniform(-0.5, 0.5, (d, d))
    K = rng.uniform(-0.5, 0.5, (d, d))
    V = rng.uniform(-0.5, 0.5, (d, d))
    got, want = _run_one(rig, Q, K, V, d)
    err = np.abs(got - want).max()
    # cheby default: an order tighter than the old 5e-3 taylor budget
    assert err < 5e-4, f"attention error {err:.2e}"


def test_encrypted_attention_multiple_seeds():
    d = 4
    rig = _rig(d, iters=4)
    for seed in (1, 7, 101):
        rng = np.random.default_rng(seed)
        Q = rng.uniform(-0.5, 0.5, (d, d))
        K = rng.uniform(-0.5, 0.5, (d, d))
        V = rng.uniform(-0.5, 0.5, (d, d))
        got, want = _run_one(rig, Q, K, V, d)
        err = np.abs(got - want).max()
        assert err < 5e-4, f"seed {seed}: attention error {err:.2e}"


def test_encrypted_attention_boundary_inputs():
    """Worst-case inputs: every entry at +/-msg_bound, so some logits sit
    EXACTLY at the contract bound B = sqrt(d)*msg_bound^2 — the window
    edge where the Chebyshev fit and Goldschmidt seed are weakest."""
    d = 4
    rig = _rig(d, iters=4)
    rng = np.random.default_rng(5)
    Q = 0.5 * np.sign(rng.standard_normal((d, d)))
    K = Q.copy()            # Q K^T diagonal = d * mb^2: logit == B exactly
    V = 0.5 * np.sign(rng.standard_normal((d, d)))
    got, want = _run_one(rig, Q, K, V, d)
    err = np.abs(got - want).max()
    assert err < 1e-3, f"boundary attention error {err:.2e}"


@pytest.mark.slow
def test_encrypted_attention_multihead():
    """heads=2 packed attention: both heads' softmax(Q_h K_h^T/sqrt(d))
    V_h decrypt from ONE pipeline run (block-masked JKLS matmuls;
    the softmax stages are head-oblivious)."""
    d, H = 4, 2
    n = 2 * H * d * d
    n_levels, _, _ = attention_plan(d, 0.5, 4, 4)
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(
        CoeffModulus.create(n, [50] + [40] * n_levels + [50]))
    parms.set_random_seed(tuple(range(11, 19)))
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    scale = 2.0 ** 40
    run, out_pid, out_scale, rot_steps = build_ckks_attention(
        ctx, d, scale, encoder, iters=4, heads=H)
    tool = ctx.first_context_data().galois_tool
    elts = [tool.get_elt_from_step(st) for st in rot_steps]
    gk = kg.galois_keys(elts)
    rot_stack = gk.stacked(*elts)
    rks = kg.relin_keys().stacked(2)

    rng = np.random.default_rng(31)
    Q = rng.uniform(-0.5, 0.5, (H, d, d))
    K = rng.uniform(-0.5, 0.5, (H, d, d))
    V = rng.uniform(-0.5, 0.5, (H, d, d))

    def pack(M):
        return enc.encrypt(encoder.encode(M.reshape(-1).tolist(), scale))

    KT = np.stack([K[h].T for h in range(H)])
    out = np.asarray(run(np.asarray(pack(Q).data), np.asarray(pack(KT).data),
                         np.asarray(pack(V).data), rot_stack, rks))
    got = np.asarray(encoder.decode(dec.decrypt(Ciphertext(
        out, out_pid, True, out_scale))))[: H * d * d].reshape(H, d, d)
    S = Q @ KT / np.sqrt(d)              # per head: Q_h @ K_h^T
    P = np.exp(S) / np.exp(S).sum(axis=2, keepdims=True)
    want = P @ V
    err = np.abs(got - want).max()
    assert err < 5e-4, f"multi-head attention error {err:.2e}"


@pytest.mark.slow
def test_encrypted_attention_d8_wide_window():
    """d=8: logit bound B = 0.707 exceeds nothing yet, but the Taylor
    window is already 6x worse than cheby here (1.7e-3 vs 1.1e-4 fit
    error); pin that the composed pipeline tracks the cheby budget and
    that auto-iters (=4 at this window) converges."""
    d = 8
    rig = _rig(d)           # auto iters
    rng = np.random.default_rng(17)
    Q = rng.uniform(-0.5, 0.5, (d, d))
    K = rng.uniform(-0.5, 0.5, (d, d))
    V = rng.uniform(-0.5, 0.5, (d, d))
    got, want = _run_one(rig, Q, K, V, d)
    err = np.abs(got - want).max()
    assert err < 1e-3, f"d=8 attention error {err:.2e}"
