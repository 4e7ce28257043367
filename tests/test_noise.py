"""Quantified noise accounting.

Every "decrypts identically" shortcut in the framework has a noise cost;
these tests MEASURE it and pin a bound, instead of asserting decrypt
equality alone:

- hoisted multi-rotation (one mod-up for k Galois elements) vs sequential
  apply_galois — the hoisting commutes the automorphism past the CRT lift
  at the cost of bounded extra noise (evaluator.py apply_galois_many);
- fused P*q_last mod-down vs sequential rescale (ops/keyswitch.fused_moddown);
- fused multi-level mod-switch (one rounded division by the product of the
  dropped primes) vs the per-level chain (ops/rnsops.MultiDropPlan);
- absolute invariant-noise-budget parity with the compiled reference
  (decryptor.cpp:269-325) on identical ciphertext bytes, oracle-gated.

Budgets use Decryptor.invariant_noise_budget (BFV; integer bits).  CKKS
costs are measured as slot-error bits against the exact plaintext value.
"""

import math
import os
import subprocess

import numpy as np
import pytest

from gemini_seal import (
    BatchEncoder,
    CKKSEncoder,
    CoeffModulus,
    Decryptor,
    EncryptionParameters,
    Encryptor,
    Evaluator,
    KeyGenerator,
    PlainModulus,
    Plaintext,
    SchemeType,
    SecLevelType,
    SealContext,
)
from gemini_seal import serialization as ser
from gemini_seal.ciphertext import Ciphertext

ORACLE = "/tmp/seal_oracle"
SEED = tuple(range(61, 69))


@pytest.fixture(scope="module")
def bfv():
    parms = EncryptionParameters(SchemeType.BFV)
    n = 256
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [40, 40, 40, 40]))
    parms.set_plain_modulus(PlainModulus.batching(n, 14))
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key(), secret_key=kg.secret_key)
    dec = Decryptor(ctx, kg.secret_key)
    return ctx, kg, enc, dec


def test_hoisted_rotation_noise_cost(bfv):
    """Hoisted rotations may cost at most 2 budget bits vs the sequential
    path (same input ciphertext, same keys)."""
    ctx, kg, enc, dec = bfv
    ev = Evaluator(ctx)
    be = BatchEncoder(ctx)
    tool = ctx.first_context_data().galois_tool
    steps = [1, 2, 3]
    elts = tool.get_elts_from_steps(steps)
    gk = kg.galois_keys(elts)

    ct = enc.encrypt(be.encode(list(range(be.slot_count))))
    seq = [ev.rotate_rows(ct, s, gk) for s in steps]
    hoisted = ev.rotate_rows_many(ct, steps, gk)

    for s, a, b in zip(steps, seq, hoisted):
        ba = dec.invariant_noise_budget(a)
        bb = dec.invariant_noise_budget(b)
        assert bb >= ba - 2, (
            f"hoisted rotation step {s}: budget {bb} vs sequential {ba}"
        )
        # and both must still decrypt correctly
        assert np.array_equal(be.decode(dec.decrypt(a)), be.decode(dec.decrypt(b)))


def test_multi_drop_noise_cost(bfv):
    """Fused multi-level mod-switch costs at most 1 budget bit vs the
    per-level chain (single rounding vs two sequential roundings)."""
    ctx, kg, enc, dec = bfv
    ev = Evaluator(ctx)
    ct = enc.encrypt(Plaintext.from_hex("5x^3 + 4"))
    last_id = ctx.last_parms_id

    chain = ev.mod_switch_to(ct, last_id)
    fused = ev.mod_switch_to(ct, last_id, fused=True)
    b_chain = dec.invariant_noise_budget(chain)
    b_fused = dec.invariant_noise_budget(fused)
    assert b_fused >= b_chain - 1, (b_fused, b_chain)
    assert dec.decrypt(fused).to_hex() == dec.decrypt(chain).to_hex()


def _slot_error_bits(got, want):
    err = max(abs(g - w) for g, w in zip(got, want))
    return math.log2(err) if err > 0 else -64.0


def test_fused_moddown_noise_cost():
    """CKKS fused P*q_last mod-down: slot error within 1 bit of the
    sequential relinearize+rescale path (same seeds, same keys)."""
    import jax

    parms = EncryptionParameters(SchemeType.CKKS)
    n = 256
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [40, 30, 40]))
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    rk = kg.relin_keys()
    scale = 2.0 ** 30

    from gemini_seal.models.pipelines import build_ckks_mul_relin_rescale

    vals = [0.5, -1.0, 2.0, 0.25, 1.5, -0.125]
    ct = enc.encrypt(encoder.encode(vals, scale))
    a = np.asarray(ct.data)
    rk_data = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])

    seq = np.asarray(jax.jit(build_ckks_mul_relin_rescale(ctx))(a, a, rk_data))
    fus = np.asarray(
        jax.jit(build_ckks_mul_relin_rescale(ctx, fused=True))(a, a, rk_data)
    )
    next_id = ctx.first_context_data().next_context_data.parms_id
    q_last = ctx.first_context_data().parms.coeff_modulus[-1].value
    s2 = scale * scale / q_last
    want = [v * v for v in vals]
    got_seq = encoder.decode(dec.decrypt(Ciphertext(seq, next_id, True, s2)))
    got_fus = encoder.decode(dec.decrypt(Ciphertext(fus, next_id, True, s2)))
    e_seq = _slot_error_bits([g.real for g in got_seq[: len(vals)]], want)
    e_fus = _slot_error_bits([g.real for g in got_fus[: len(vals)]], want)
    assert e_fus <= e_seq + 1.0, (
        f"fused mod-down error 2^{e_fus:.2f} vs sequential 2^{e_seq:.2f}"
    )


@pytest.mark.skipif(not os.path.exists(ORACLE), reason="oracle not built")
def test_budget_matches_reference(tmp_path):
    """Our invariant_noise_budget equals the compiled reference's on the
    SAME ciphertext bytes (fresh, after multiply, after relinearize) —
    absolute noise parity, not just relative deltas.
    Uses the oracle's pinned 64/{40,40,40}/t=257 BFV config."""
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(64)
    parms.set_coeff_modulus(CoeffModulus.create(64, [40, 40, 40]))
    parms.set_plain_modulus(257)
    parms.set_random_seed(SEED)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    dec = Decryptor(ctx, kg.secret_key)
    ev = Evaluator(ctx)
    rk = kg.relin_keys()

    (tmp_path / "sk.bin").write_bytes(ser.save(kg.secret_key, ser.COMPR_NONE))

    ct = enc.encrypt(Plaintext.from_hex("3x^2 + 2"))
    prod = ev.multiply(ct, ct)
    rel = ev.relinearize(prod, rk)
    for name, c in (("fresh", ct), ("prod", prod), ("relin", rel)):
        p = tmp_path / f"{name}.bin"
        p.write_bytes(ser.save(c, ser.COMPR_NONE))
        out = subprocess.run(
            [ORACLE, "budget", str(tmp_path), str(p)],
            check=True, capture_output=True, text=True,
        )
        ref_budget = int(out.stdout.strip())
        ours = dec.invariant_noise_budget(c)
        assert ours == ref_budget, (name, ours, ref_budget)
