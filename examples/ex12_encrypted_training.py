"""Example 12: encrypted model TRAINING — logistic regression by
gradient descent where BOTH the data X and the model w stay encrypted.

This is the iDASH-style HE training workload (Kim et al., "Secure
Logistic Regression Based on Homomorphic Encryption"): a client uploads
an encrypted training set once; the server iterates

    w <- w - alpha * X^T (sigma3(X w) - y),     sigma3 = degree-3 sigmoid,

entirely under encryption and returns the encrypted trained model.  Each
iteration is ONE jitted program (models.pipelines.build_ckks_logreg_train_step)
consuming 7 modulus levels; the output w' lands replicated per sample
block at the INPUT scale, so with a deep enough chain the same program
shape chains for several iterations without any client round trip.

The reference stops at the op layer (its examples end at rotations);
this is the model-zoo layer built on top.  Usage:
python ex12_encrypted_training.py
"""

import numpy as np

from common import print_parameters

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
from gemini_seal.ciphertext import Ciphertext
from gemini_seal.models.pipelines import build_ckks_logreg_train_step


def main():
    import jax

    # 7 levels per GD iteration; 15 working primes = two iterations on
    # one chain before the client re-encrypts (or bootstraps, offline).
    n = 2048
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [50] + [40] * 14 + [50]))
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    print_parameters(ctx)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    dec = Decryptor(ctx, kg.secret_key)
    encoder = CKKSEncoder(ctx)
    tool = ctx.first_context_data().galois_tool
    rk = kg.relin_keys()
    scale = 2.0 ** 40

    # A toy separable dataset: m samples, F features.
    m, F = 16, 4
    Bf = 4  # slot block per sample (next power of two >= F)
    rng = np.random.default_rng(5)
    true_w = np.array([1.0, -1.5, 0.8, 0.3])
    X = rng.uniform(-1, 1, size=(m, F))
    y = (X @ true_w + 0.1 * rng.standard_normal(m) > 0).astype(float)
    w = np.zeros(F)
    alpha = 0.5

    print(f"-- training set: m={m} samples, F={F} features "
          f"(block size {Bf}, {encoder.slot_count} slots)")

    # Client side: pack and encrypt X (once) and the initial w.
    slots = encoder.slot_count
    xs = np.zeros(slots)
    for i in range(m):
        xs[i * Bf:i * Bf + F] = X[i]
    ws = np.zeros(slots)
    for i in range(slots // Bf):
        ws[i * Bf:i * Bf + F] = w
    ct_x = enc.encrypt(encoder.encode(xs.tolist(), scale))
    ct_w = enc.encrypt(encoder.encode(ws.tolist(), scale))

    # Server side: two GD iterations as two jitted programs (the second
    # built at the 7-levels-dropped parms the first one outputs).
    fn1, pid1, sc1, rot_steps = build_ckks_logreg_train_step(
        ctx, m, F, y.tolist(), alpha, scale, encoder)
    fn2, pid2, sc2, _ = build_ckks_logreg_train_step(
        ctx, m, F, y.tolist(), alpha, scale, encoder, parms_id=pid1)
    elts = [tool.get_elt_from_step(s) for s in rot_steps]
    gk = kg.galois_keys(elts)
    gks = gk.stacked(*elts)
    rks = rk.stacked(2)

    L1 = len(ctx.get_context_data(pid1).parms.coeff_modulus)
    w1 = np.asarray(jax.jit(fn1)(
        np.asarray(ct_x.data), np.asarray(ct_w.data), gks, rks))
    w2 = np.asarray(jax.jit(fn2)(
        np.asarray(ct_x.data)[..., :L1, :], w1, gks, rks))

    # Plaintext reference: the same degree-3-sigmoid GD updates.
    def gd(wv):
        z = X @ wv
        s = 0.5 + 0.197 * z - 0.004 * z ** 3
        return wv - alpha * (X.T @ (s - y))

    want = gd(gd(w))
    got = encoder.decode(dec.decrypt(Ciphertext(w2, pid2, True, sc2)))[:F]
    print("   encrypted w after 2 iterations:",
          np.round(np.real(got), 5).tolist())
    print("   plaintext w after 2 iterations:", np.round(want, 5).tolist())
    err = max(abs(np.real(got[j]) - want[j]) for j in range(F))
    print(f"   max |error| = {err:.2e}")
    assert err < 1e-2

    # Training accuracy of the encrypted-trained model.
    acc = float(np.mean((X @ np.real(got[:F]) > 0) == (y > 0.5)))
    print(f"   training accuracy after 2 encrypted iterations: {acc:.2f}")


if __name__ == "__main__":
    main()
