"""Example 11: an encrypted CNN — CryptoNets-style image inference.

A convolutional network evaluated ENTIRELY on encrypted data: the client
encrypts an image, the server runs conv + square + dense + square +
readout without ever decrypting, the client decrypts the class scores.
This mirrors the CryptoNets workload (the canonical SEAL application)
on the framework's fused one-program pipelines:

- stride-1 SAME conv as masked generalized diagonals riding the hoisted
  matvec (ONE key-switch mod-up + ONE special-prime mod-down per layer;
  models.pipelines.build_ckks_conv2d, periodic mode);
- square activations (the HE-friendly nonlinearity);
- dense layers on the baby-step/giant-step schedule (~2*sqrt(k) key
  switches for k diagonals; build_ckks_matvec_bsgs);
- the whole network chained down the modulus chain as ONE jitted
  program (build_ckks_cnn).

The reference stops at the op layer (rotations, multiplies); this is the
model-zoo layer built on top.  Usage: python ex11_encrypted_cnn.py
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
from gemini_seal.models.pipelines import build_ckks_cnn


def main():
    import jax

    # 8 levels: conv+square (2) + dense+square (2) + readout (1) + margin
    parms = EncryptionParameters(SchemeType.CKKS)
    n = 4096
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(
        CoeffModulus.create(n, [50, 40, 40, 40, 40, 40, 40, 50])
    )
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    print_parameters(ctx)
    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    dec = Decryptor(ctx, kg.secret_key)
    encoder = CKKSEncoder(ctx)
    tool = ctx.first_context_data().galois_tool
    rk = kg.relin_keys()
    scale = 2.0 ** 40

    # ---- the model (random weights standing in for trained ones) -------
    h, w = 16, 16
    hw = h * w
    rng = np.random.default_rng(0)
    kernel = rng.uniform(-0.4, 0.4, size=(3, 3))
    conv_bias = rng.uniform(-0.1, 0.1, size=hw)
    dense_steps = list(range(16))            # 256x256, 16-diagonal band
    M = np.zeros((hw, hw))
    for d in dense_steps:
        for i in range(hw):
            M[i, (i + d) % hw] = rng.uniform(-0.15, 0.15)
    dense_bias = rng.uniform(-0.1, 0.1, size=hw)
    R = np.zeros((hw, hw))                    # 10-class readout band
    for d in range(10):
        for i in range(hw):
            R[i, (i + d) % hw] = rng.uniform(-0.3, 0.3)

    image = rng.uniform(0.0, 1.0, size=(h, w))

    # ---- clear-model forward pass (what the server's math must equal) --
    conv = np.zeros((h, w))
    for r in range(h):
        for c in range(w):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if 0 <= r + dy < h and 0 <= c + dx < w:
                        conv[r, c] += kernel[dy + 1, dx + 1] * image[r + dy, c + dx]
    a1 = (conv.reshape(-1) + conv_bias) ** 2
    a2 = (M @ a1 + dense_bias) ** 2
    scores = R @ a2

    # ---- build the encrypted network -----------------------------------
    slots = encoder.slot_count
    per = lambda v: [v[i % hw] for i in range(slots)]  # block-periodic
    diagonals = {
        d: [M[i % hw, (i + d) % hw] for i in range(slots)]
        for d in dense_steps
    }
    readout = {
        d: [R[i % hw, (i + d) % hw] for i in range(slots)] for d in range(10)
    }
    fn, out_pid, out_scale = build_ckks_cnn(
        ctx,
        convs=[(kernel, per(conv_bias), "square")],
        dense=[(diagonals, per(dense_bias), "square"),
               (readout, [0.0] * slots, None)],
        height=h, width=w, scale=scale, encoder=encoder, bsgs=True,
    )
    print("rotation keys per layer:",
          [len(s) for s in fn.rot_steps],
          f"(dense layer on BSGS: {fn.rot_steps[1]} vs "
          f"{len(dense_steps) - 1} flat)")

    gk_stacks = []
    for layer_steps in fn.rot_steps:
        elts = [tool.get_elt_from_step(s) for s in layer_steps]
        gk = kg.galois_keys(elts)
        gk_stacks.append(gk.stacked(*elts))

    # ---- client: encrypt the (block-periodic) image --------------------
    ct = enc.encrypt(encoder.encode(per(image.reshape(-1)), scale))

    # ---- server: one jitted program, never sees the plaintext ----------
    step = jax.jit(lambda c, g0, g1, g2, r: fn(c, (g0, g1, g2), r))
    out = np.asarray(step(np.asarray(ct.data), *gk_stacks, rk.stacked(2)))

    # ---- client: decrypt the scores ------------------------------------
    got = encoder.decode(dec.decrypt(Ciphertext(out, out_pid, True, out_scale)))
    print("class scores (first 10 outputs):")
    for i in range(10):
        print(f"  encrypted {got[i].real:+.6f}   clear {scores[i]:+.6f}")
    err = max(abs(got[i].real - scores[i]) for i in range(hw))
    print(f"max |error| over all {hw} outputs: {err:.2e}")
    assert err < 1e-2


if __name__ == "__main__":
    main()
