"""Example 14: encrypted SOFTMAX — composing the numerical toolkit.

softmax(x)_i = exp(x_i) / sum_j exp(x_j) requires three things no
per-op HE library provides natively: a transcendental (exp), a
data-dependent reduction (the slot sum), and DIVISION by an encrypted
value.  This example composes them from the model zoo:

    exp     models.pipelines.build_ckks_poly_eval   degree-4 Taylor
    sum     Evaluator.rotate_vector log-tree        slot-sum, replicated
    1/sum   models.pipelines.build_ckks_inverse     Goldschmidt iteration
    out     multiply + rescale                      e_i * (1/sum)

Range reduction for the Goldschmidt domain (0, 2): one EXACT plain
multiply by 1/16 (the coefficient is the integer 64 at encode scale
2^10) whose rescale simultaneously pulls the working scale back to the
prime size, keeping the inverse's squared-scale track stationary; the
final out_scale multiplies the 16 back in.

Usage: python ex14_encrypted_softmax.py   (~1 min of one-time compile)
"""

import numpy as np

from common import print_parameters

from gemini_seal import (
    CKKSEncoder,
    CoeffModulus,
    Decryptor,
    EncryptionParameters,
    Encryptor,
    Evaluator,
    KeyGenerator,
    SchemeType,
    SecLevelType,
    SealContext,
)
from gemini_seal.ciphertext import Ciphertext
from gemini_seal.models.pipelines import (
    build_ckks_inverse,
    build_ckks_poly_eval,
)


def main():
    import jax

    n = 256
    k = 8                                   # softmax width (slots used)
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [50] + [40] * 11 + [50]))
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    print_parameters(ctx)

    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    dec = Decryptor(ctx, kg.secret_key)
    encoder = CKKSEncoder(ctx)
    ev = Evaluator(ctx)
    tool = ctx.first_context_data().galois_tool
    scale = 2.0 ** 40

    # logits, replicated around the slot ring so the rotation sum wraps
    rng = np.random.default_rng(41)
    x = rng.uniform(-1, 1, k)
    slots = encoder.slot_count
    xs = [float(x[i % k]) for i in range(slots)]
    ct = enc.encrypt(encoder.encode(xs, scale))

    # --- exp(x) by a degree-4 Taylor pipeline (3 levels) -----------------
    coeffs = [1.0, 1.0, 0.5, 1.0 / 6.0, 1.0 / 24.0]
    exp_fn, exp_pid, exp_scale = build_ckks_poly_eval(
        ctx, coeffs, scale, encoder)
    rk = kg.relin_keys()
    rks = rk.stacked(2)
    empty_gk = np.zeros((0,), dtype=np.uint64)
    e_data = np.asarray(jax.jit(exp_fn)(np.asarray(ct.data), rks, empty_gk))
    ct_e = Ciphertext(e_data, exp_pid, True, exp_scale)

    # --- slot sum by a log2(k) rotation tree ------------------------------
    gk = kg.galois_keys([tool.get_elt_from_step(1 << i) for i in range(3)])
    ct_sum = ct_e
    for i in range(3):                      # k = 8 = 2^3
        ct_sum = ev.add(ct_sum, ev.rotate_vector(ct_sum, 1 << i, gk))

    # --- range reduction: sum in [2.9, 21.8] -> sum/16 in (0, 2), the
    # Goldschmidt domain.  1/16 encodes EXACTLY at scale 2^10 (the
    # coefficient is the integer 64), and one rescale also pulls the
    # working scale from poly_eval's 2^70 back to ~2^40 = the prime
    # size, which keeps the inverse's squared-scale track stationary --
    pt_red = encoder.encode(1.0 / 16.0, 2.0 ** 10, ct_sum.parms_id)
    ct_red = ev.rescale_to_next(ev.multiply_plain(ct_sum, pt_red))

    # --- 1/(sum/16) by Goldschmidt ----------------------------------------
    inv_fn, inv_pid, inv_scale = build_ckks_inverse(
        ctx, ct_red.scale, encoder, iters=4, parms_id=ct_red.parms_id)
    inv_data = np.asarray(jax.jit(inv_fn)(np.asarray(ct_red.data), rks))
    ct_inv = Ciphertext(inv_data, inv_pid, True, inv_scale)

    # --- softmax_i = e_i * (16/sum) / 16 ----------------------------------
    ct_e_dn = ev.mod_switch_to(ct_e, inv_pid)
    out = ev.rescale_to_next(ev.relinearize(ev.multiply(ct_e_dn, ct_inv), rk))
    out.scale *= 16.0                       # undo the range reduction
    got = np.asarray(encoder.decode(dec.decrypt(out)))[:k]

    want = np.exp(x) / np.exp(x).sum()
    err = np.abs(got - want).max()
    print("softmax (encrypted):", np.round(got, 4))
    print("softmax (plain):    ", np.round(want, 4))
    print(f"max abs error {err:.2e} "
          f"(deg-4 exp tail + 4 Goldschmidt iterations)")
    assert err < 2e-2
    print("ex14 OK")


if __name__ == "__main__":
    main()
