"""Example 9: encrypted inference — a dense layer on encrypted input.

y = act(M @ x + b) with x encrypted and M, b in the clear (the canonical
encrypted-inference shape: the server evaluates its model on a client's
encrypted features).  Built from the framework's production pieces:

- diagonal-method matvec with HOISTED rotations (one key-switch mod-up
  feeds every rotation; models.pipelines.build_ckks_matvec);
- rescale + plaintext bias add;
- square activation (x^2) via multiply + relinearize + rescale.

Usage: python ex9_encrypted_inference.py [--dim 8]
"""

import argparse

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
from gemini_seal.models.pipelines import build_ckks_matvec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=8)
    args = ap.parse_args()
    dim = args.dim

    import jax

    parms = EncryptionParameters(SchemeType.CKKS)
    n = 4096
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [50, 40, 40, 40, 50]))
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    print_parameters(ctx)

    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    dec = Decryptor(ctx, kg.secret_key)
    ev = Evaluator(ctx)
    encoder = CKKSEncoder(ctx)
    tool = ctx.first_context_data().galois_tool
    rk = kg.relin_keys()
    scale = 2.0 ** 40

    # the model (cleartext, server side)
    rng = np.random.default_rng(42)
    M = rng.uniform(-0.5, 0.5, size=(dim, dim))
    b = rng.uniform(-0.2, 0.2, size=dim)
    x = rng.uniform(-1, 1, size=dim)

    # client: encrypt the features, periodically extended so rotations wrap
    slots = encoder.slot_count
    x_slots = [x[i % dim] for i in range(slots)]
    ct = enc.encrypt(encoder.encode(x_slots, scale))

    # server: generalized diagonals + hoisted-rotation keys
    diagonals = {
        d: [M[i % dim, (i + d) % dim] for i in range(slots)] for d in range(dim)
    }
    steps = sorted(s for s in diagonals if s != 0)
    elts = [tool.get_elt_from_step(s) for s in steps]
    gk = kg.galois_keys(elts)
    gk_stack = np.stack([
        np.stack([np.asarray(pk.data.data) for pk in gk.key(e)]) for e in elts
    ])

    matvec = jax.jit(build_ckks_matvec(ctx, diagonals, scale, encoder))
    out = np.asarray(matvec(np.asarray(ct.data), gk_stack))
    mv = Ciphertext(out, ct.parms_id, True, scale * scale)

    # rescale, add bias, square activation
    mv = ev.rescale_to_next(mv)
    bias_pt = encoder.encode([b[i % dim] for i in range(slots)], mv.scale,
                             mv.parms_id)
    z = ev.add_plain(mv, bias_pt)
    act = ev.rescale_to_next(ev.relinearize(ev.multiply(z, z), rk))

    got = encoder.decode(dec.decrypt(act))[:dim]
    want = (M @ x + b) ** 2
    err = max(abs(g - w) for g, w in zip(got, want))
    print("encrypted:", [round(float(g), 4) for g in got[:4]], "...")
    print("cleartext:", [round(float(w), 4) for w in want[:4]], "...")
    print(f"max error: {err:.2e}")
    assert err < 1e-3

    # the same layer as ONE fused jitted program (raw-accumulator matvec
    # with a single mod-down + rescale + bias + square, fully on device)
    from gemini_seal.models.pipelines import build_ckks_dense_layer

    bias = [b[i % dim] for i in range(slots)]
    rk_data = np.stack([np.asarray(pk.data.data) for pk in rk.key(2)])
    layer, out_id, out_scale = build_ckks_dense_layer(
        ctx, diagonals, bias, scale, encoder
    )
    fused_out = np.asarray(jax.jit(layer)(np.asarray(ct.data), gk_stack, rk_data))
    got_f = encoder.decode(
        dec.decrypt(Ciphertext(fused_out, out_id, True, out_scale))
    )[:dim]
    err_f = max(abs(g - w) for g, w in zip(got_f, want))
    print(f"fused one-program layer max error: {err_f:.2e}")
    assert err_f < 1e-3
    print("ex9 OK — dense layer with square activation on encrypted input")


if __name__ == "__main__":
    main()
