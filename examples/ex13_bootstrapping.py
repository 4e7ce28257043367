"""Example 13: CKKS BOOTSTRAPPING — refresh an exhausted ciphertext to a
usable level without ever decrypting it.

Leveled CKKS (all the reference supports — its examples end at rotations)
dies when the modulus chain runs out: every multiplication consumes one
prime, and once a single prime is left no further products are possible.
Bootstrapping (Cheon-Han-Kim-Kim-Song) lifts the dead ciphertext back
near the TOP of the chain while preserving the encrypted message:

    mod_raise     residues re-lifted to the full chain (value m + q0*I)
    CoeffToSlot   homomorphic decode: coefficients -> slots (BSGS matvecs)
    EvalMod       approximate m + q0*I mod q0 via exp-Taylor + r
                  double-angle squarings (sin(2 pi t)/2 pi ~ frac(t))
    SlotToCoeff   homomorphic encode: slots -> coefficients

The whole refresh is a composition of this framework's jitted pipelines —
one Python callable chaining per-stage XLA programs (models/bootstrap.py).

Two linear-map strategies:
  linear_mode="dense"  4+4 dense BSGS matvecs, 2 levels per transform;
  linear_mode="split"  log-depth FFT factorization of the slot transform,
                       O(2^radix) plaintext diagonals per level — the
                       footprint that scales to large slot counts.

Usage: python ex13_bootstrapping.py        (~2-4 min of one-time XLA
compile on a single CPU core; cached afterwards in .jax_cache)
"""

import math

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
from gemini_seal.models.bootstrap import build_ckks_bootstrap


def main():
    # Precision tracks scale/q0 (the EvalMod output error is the squaring
    # chain's rescale noise amplified by q0/(2 pi scale)): 45-bit working
    # primes at a 59-bit base prime give ~2e-4..2e-3 refresh error.
    # r=8 double-angle squarings keep the Taylor argument small at this N.
    n = 128
    r = 8
    bits = [59] + [45] * 17 + [59]
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, bits))
    parms.set_random_seed((1, 2, 3, 4, 5, 6, 7, 8))
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    print_parameters(ctx)

    kg = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=kg.public_key())
    dec = Decryptor(ctx, kg.secret_key)
    encoder = CKKSEncoder(ctx)
    ev = Evaluator(ctx)
    tool = ctx.first_context_data().galois_tool
    scale = 2.0**45

    # Build the bootstrap program FIRST: it reports which rotation keys
    # the CoeffToSlot/SlotToCoeff matvecs need.
    fn, out_pid, out_scale, rot_steps, conj_elt = build_ckks_bootstrap(
        ctx, scale, encoder, r=r, linear_mode="split", radix=3
    )
    elts = [tool.get_elt_from_step(s) for s in rot_steps]
    gk = kg.galois_keys(elts + [conj_elt])
    rot_stack = gk.stacked(*elts)
    conj_stack = gk.stacked(conj_elt)
    rks = kg.relin_keys().stacked(2)
    print(f"bootstrap program: {len(rot_steps)} rotation keys + conjugation,"
          f" linear_mode=split")

    # A message, encrypted fresh ...
    rng = np.random.default_rng(13)
    s = encoder.slot_count
    msg = rng.uniform(-1, 1, s) + 1j * rng.uniform(-1, 1, s)
    ct = enc.encrypt(encoder.encode(msg.tolist(), scale))

    # ... then EXHAUST the chain: mod-switch all the way down to ONE prime.
    while ctx.get_context_data(ct.parms_id).next_context_data is not None:
        ct = ev.mod_switch_to_next(ct)
    L_dead = len(ctx.get_context_data(ct.parms_id).parms.coeff_modulus)
    print(f"ciphertext exhausted: {L_dead} prime left "
          f"(no further multiplication possible)")

    # Refresh. Same message, same scale, restored level.
    out = np.asarray(fn(np.asarray(ct.data), rot_stack, conj_stack, rks))
    got = np.asarray(
        encoder.decode(
            dec.decrypt(Ciphertext(out, out_pid, True, out_scale)),
            as_complex=True,
        )
    )[:s]
    L_out = len(ctx.get_context_data(out_pid).parms.coeff_modulus)
    err = float(np.abs(got - msg).max())
    print(f"refreshed to L={L_out} primes at scale 2^"
          f"{int(round(math.log2(out_scale)))}; max slot error {err:.2e}")
    assert err < 2e-3, "refresh error above the documented floor"

    # The refreshed ciphertext is ALIVE again: square it and decrypt.
    sq = ev.rescale_to_next(
        ev.relinearize(ev.multiply(Ciphertext(out, out_pid, True, out_scale),
                                   Ciphertext(out, out_pid, True, out_scale)),
                       kg.relin_keys()))
    got2 = np.asarray(encoder.decode(dec.decrypt(sq), as_complex=True))[:s]
    err2 = float(np.abs(got2 - msg * msg).max())
    print(f"post-refresh square decrypts with max error {err2:.2e}")
    assert err2 < 5e-2
    print("ex13 OK")


if __name__ == "__main__":
    main()
