"""CKKS bootstrapping tests.

No reference analogue (SEAL 3.5 / the Gemini-SEAL fork stop at leveled
CKKS — once the chain is consumed the ciphertext is dead), so there is no
oracle to pin against; correctness is established structurally:

- the slot matrices are derived from the encoder's OWN embedding and
  checked as exact linear-algebra inverses + against encode/decode;
- mod_raise is an exact integer statement (centered lift residue match),
  checked coefficient-by-coefficient against Python ints;
- the end-to-end refresh (test_bootstrap_e2e) decrypts to the original
  message within the sin-approximation bound at a RESTORED level.
"""

import math

import numpy as np
import pytest

from gemini_seal import (
    CKKSEncoder,
    CoeffModulus,
    Decryptor,
    EncryptionParameters,
    Encryptor,
    Evaluator,
    KeyGenerator,
    SchemeType,
    SealContext,
    SecLevelType,
)
from gemini_seal.ciphertext import Ciphertext
from gemini_seal.models.bootstrap import (
    ModRaisePlan,
    _matrix_diagonals,
    build_ckks_bootstrap,
    derive_slot_matrices,
    mod_raise,
)
from gemini_seal.ops.ntt import ntt_forward, ntt_inverse


def _ckks_context(n, bits, seed=(1, 2, 3, 4, 5, 6, 7, 8), nsp=1):
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, bits))
    parms.set_n_special_primes(nsp)
    parms.set_random_seed(seed)
    return SealContext(parms, sec_level=SecLevelType.none)


def test_slot_matrices_are_inverse_pair():
    ctx = _ckks_context(64, [40, 40, 40])
    encoder = CKKSEncoder(ctx)
    E, Minv = derive_slot_matrices(encoder)
    n, s = encoder._n, encoder.slots
    assert E.shape == (s, n) and Minv.shape == (n, n)
    stacked = np.vstack([E, np.conj(E)])
    assert np.abs(stacked @ Minv - np.eye(n)).max() < 1e-9
    # coefficients recovered from (slots, conj slots) are REAL: the map
    # round-trips an arbitrary slot vector through real polynomial space
    rng = np.random.default_rng(3)
    z = rng.normal(size=s) + 1j * rng.normal(size=s)
    c = Minv @ np.concatenate([z, np.conj(z)])
    assert np.abs(c.imag).max() < 1e-9
    assert np.abs(E @ c - z).max() < 1e-9


def test_slot_matrix_matches_encoder_decode():
    """E really is the decode map: push an encoded message's centered
    coefficients through E and compare with the message."""
    ctx = _ckks_context(64, [50, 50, 50])
    encoder = CKKSEncoder(ctx)
    E, _ = derive_slot_matrices(encoder)
    scale = 2.0**30
    rng = np.random.default_rng(5)
    s = encoder.slots
    msg = rng.uniform(-1, 1, s) + 1j * rng.uniform(-1, 1, s)
    pt = encoder.encode(msg.tolist(), scale)
    cd = ctx.get_context_data(pt.parms_id)
    q = [m.value for m in cd.parms.coeff_modulus]
    coeffs = np.asarray(ntt_inverse(np.asarray(pt.data), cd.ntt_tables))
    # CRT-compose the residues and center
    vals = []
    Q = math.prod(q)
    for k in range(encoder._n):
        x = 0
        for j, qj in enumerate(q):
            Qj = Q // qj
            x = (x + int(coeffs[j, k]) * Qj * pow(Qj, -1, qj)) % Q
        vals.append(x - Q if x > Q // 2 else x)
    got = E @ (np.asarray(vals, dtype=np.float64) / scale)
    assert np.abs(got - msg).max() < 1e-4


def test_matrix_diagonals_convention():
    """y = sum_d diag_d * rot(x, d) with rot(x, d)[i] = x[(i + d) % s]
    reconstructs M @ x — the exact convention build_ckks_matvec* use."""
    rng = np.random.default_rng(7)
    s = 16
    M = rng.normal(size=(s, s)) + 1j * rng.normal(size=(s, s))
    x = rng.normal(size=s) + 1j * rng.normal(size=s)
    diags = _matrix_diagonals(M)
    y = np.zeros(s, dtype=np.complex128)
    for d, vec in diags.items():
        y += vec * np.roll(x, -d)
    assert np.abs(y - M @ x).max() < 1e-10


def test_mod_raise_exact_centered_lift():
    """mod_raise is an exact integer map: each output residue equals the
    centered lift of the q0 residue reduced mod that prime."""
    n = 64
    ctx = _ckks_context(n, [59, 40, 40, 41, 59])
    top = ctx.first_context_data()
    last = top
    while last.next_context_data is not None:
        last = last.next_context_data
    assert len(last.parms.coeff_modulus) == 1
    plan = ModRaisePlan(ctx, last.parms_id, top.parms_id)
    q0 = plan.q0

    rng = np.random.default_rng(11)
    c = rng.integers(0, q0, size=(2, 1, n), dtype=np.uint64)
    raised = mod_raise(ntt_forward(c, last.ntt_tables), plan)
    out = np.asarray(ntt_inverse(raised, top.ntt_tables))
    ps = [m.value for m in top.parms.coeff_modulus]
    for j, p in enumerate(ps):
        for poly in range(2):
            for k in range(n):
                v = int(c[poly, 0, k])
                v = v - q0 if v > q0 // 2 else v
                assert int(out[poly, j, k]) == v % p


def test_special_fft_stages_factor_the_slot_transform():
    """prod(fwd stages) @ bit-reversal == E1 (the decode map's first
    coefficient half), E[:, s:] == i*E1 (the packing identity), and the
    inverse chain with the permutation OMITTED still roundtrips through a
    slot-wise function — the exact cancellation split-mode relies on."""
    from gemini_seal.models.bootstrap import (_collapse_chain,
                                                  special_fft_stage_diagonals)

    ctx = _ckks_context(128, [45, 45])
    encoder = CKKSEncoder(ctx)
    s = encoder.slots
    E, _ = derive_slot_matrices(encoder)
    E1 = E[:, :s]
    assert np.abs(E[:, s:] - 1j * E1).max() < 1e-12

    fwd, inv = special_fft_stage_diagonals(encoder)

    def dense(D):
        M = np.zeros((s, s), complex)
        for d, v in D.items():
            M[np.arange(s), (np.arange(s) + d) % s] = v
        return M

    bits = int(np.log2(s))
    brp = np.array([int(format(i, f"0{bits}b")[::-1], 2) for i in range(s)])
    P = np.zeros((s, s))
    P[np.arange(s), brp] = 1
    F = P.copy()
    for B in fwd:
        F = dense(B) @ F
    assert np.abs(F - E1).max() < 1e-9

    def apply_diag(D, x):
        y = np.zeros_like(x)
        for d, v in D.items():
            y = y + v * np.roll(x, -d)
        return y

    rng = np.random.default_rng(9)
    z = rng.normal(size=s) + 1j * rng.normal(size=s)
    for radix in (2, 3):
        c2s = _collapse_chain(list(reversed(inv)), s, radix)
        s2c = _collapse_chain(fwd, s, radix)
        # collapsed groups stay sparse: <= 2^(radix+1) - 1 diagonals
        assert all(len(g) <= 2 ** (radix + 1) - 1 for g in c2s + s2c)
        t = z.copy()
        for g in c2s:
            t = apply_diag(g, t)
        t = 3.0 * t            # any slot-wise map commutes with P
        for g in s2c:
            t = apply_diag(g, t)
        assert np.abs(t - 3.0 * z).max() < 1e-9


def _run_bootstrap_e2e(linear_mode, radix=3, evalmod="cosine", tol=1e-4,
                       n=128, nsp=1):
    """Full refresh at N=`n`: exhaust the chain, bootstrap, decrypt —
    same message, same scale.

    evalmod="exp" (round-3 path): r=8 explicit — deg-7 Taylor at arg <=
    2pi*K'/2^r ~ 0.35 rad still contributes < 1e-4 and keeps the chain
    compileable; the output error floor is the squaring-chain noise
    amplified by 2^r * q0/(2*pi*scale) — measured 1.4e-2 max at 40-bit
    primes, ~2e-4 at 45-bit (dense mode).

    evalmod="cosine" (default): Chebyshev-cosine EvalMod with auto r.
    Split mode uses the round-5 Dl_em layout (59-bit primes on every
    bootstrap-consumed level): the refresh error floor collapses from
    the 45-bit layout's q0/Dl-amplified ~4e-5 to the ~1e-7 regime, so
    split tests pin tol=1e-6."""
    from gemini_seal.models.evalmod import plan_evalmod

    if evalmod == "exp":
        r = 8
        em_depth = 4 + r
    else:
        r = None
        K = max(12, int(math.ceil(4.5 * math.sqrt(n / 18.0))))
        r_auto, _, em_depth = plan_evalmod(K)
    if linear_mode == "split":
        gn = (int(math.log2(n // 2)) + radix - 1) // radix
        n_levels = 2 * gn + em_depth + (1 if evalmod == "cosine" else 0)
    else:
        n_levels = 4 + em_depth
    # exp mode and dense mode stay on the legacy all-45 layout (their
    # scale algebra is stationary at 45-bit primes); split-cosine gets
    # the 59-bit Dl_em levels
    em = 59 if (evalmod == "cosine" and linear_mode == "split") else 45
    bits = [59] + [45] * (2 if em == 45 else 1) \
        + [em] * (n_levels - (1 if em == 45 else 0)) + [59] * nsp
    ctx = _ckks_context(n, bits, nsp=nsp)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    encoder = CKKSEncoder(ctx)
    dec = Decryptor(ctx, kg.secret_key)
    ev = Evaluator(ctx)
    tool = ctx.first_context_data().galois_tool
    scale = 2.0**45

    fn, out_pid, out_scale, rot_steps, conj_elt = build_ckks_bootstrap(
        ctx, scale, encoder, r=r, linear_mode=linear_mode, radix=radix,
        evalmod=evalmod,
    )
    elts = [tool.get_elt_from_step(s) for s in rot_steps]
    gk = kg.galois_keys(elts + [conj_elt])
    rot_stack = gk.stacked(*elts)
    conj_stack = gk.stacked(conj_elt)
    rks = kg.relin_keys().stacked(2)

    rng = np.random.default_rng(13)
    s = encoder.slot_count
    msg = rng.uniform(-1, 1, s) + 1j * rng.uniform(-1, 1, s)
    ct = enc.encrypt(encoder.encode(msg.tolist(), scale))
    while ctx.get_context_data(ct.parms_id).next_context_data is not None:
        ct = ev.mod_switch_to_next(ct)
    assert len(ctx.get_context_data(ct.parms_id).parms.coeff_modulus) == 1

    out = np.asarray(fn(np.asarray(ct.data), rot_stack, conj_stack, rks))
    got = np.asarray(
        encoder.decode(
            dec.decrypt(Ciphertext(out, out_pid, True, out_scale)),
            as_complex=True,
        )
    )[:s]
    err = np.abs(got - msg).max()
    assert err < tol, f"refresh error {err:.2e} above {tol:.0e}"
    L_out = len(ctx.get_context_data(out_pid).parms.coeff_modulus)
    assert L_out >= 2  # usable multiplicative depth restored
    assert math.isclose(out_scale, scale, rel_tol=1e-9)
    return len(rot_steps), L_out, err


@pytest.mark.bootstrap_e2e
def test_bootstrap_e2e():
    _run_bootstrap_e2e("dense")


@pytest.mark.bootstrap_e2e
def test_bootstrap_e2e_split():
    """Log-depth FFT-factored linear maps: same refresh quality with
    ~half the rotation keys and O(2^radix) plaintext diagonals per level.
    Round-5 Dl_em layout: pins the 1e-6 floor (measured 3.6e-8)."""
    n_keys, L_out, _ = _run_bootstrap_e2e("split", radix=3, tol=1e-6)
    # union of collapsed-group offsets: <= 2^(radix+1)-2 nonzero per
    # group, 2*ceil(log2(s)/radix) groups — O(2^radix * log s), beating
    # dense's 2*sqrt(s) once s is large (at s=64 it's 21, measured)
    assert n_keys <= 4 * (2 ** 3)


@pytest.mark.bootstrap_e2e
def test_bootstrap_e2e_exp_legacy():
    """The round-3 exp-trick EvalMod still refreshes (looser 2e-3 floor:
    its r=8 double-angle chain amplifies rescale noise 2^8)."""
    _run_bootstrap_e2e("dense", evalmod="exp", tol=2e-3)


@pytest.mark.bootstrap_e2e
def test_bootstrap_e2e_n1024_production():
    """Non-toy shape: N=1024, nsp=2 special primes,
    radix=4 (the bench configuration's radix) — K=34, so the Chebyshev
    degree (90) and double-angle count are production-sized, not the
    N=128 toy's.  On the round-5 Dl_em layout the measured refresh error
    is 1.2e-6 max (med 2.5e-7); tol=5e-6 pins it with ~4x headroom —
    37x below the 45-bit layout's floor at this shape."""
    _, L_out, err = _run_bootstrap_e2e("split", radix=4, n=1024, nsp=2,
                                       tol=5e-6)
    assert L_out >= 2
