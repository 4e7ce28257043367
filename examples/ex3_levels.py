"""Example 3: levels (reference: native/examples/3_levels.cpp).

The modulus-switching chain: walking parms_ids, switching ciphertexts and
noise-budget management down the chain.
"""

from common import print_parameters

from gemini_seal import (
    CoeffModulus,
    Decryptor,
    EncryptionParameters,
    Encryptor,
    Evaluator,
    KeyGenerator,
    Plaintext,
    SchemeType,
    SealContext,
)


def main():
    parms = EncryptionParameters(SchemeType.BFV)
    n = 8192
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [50, 30, 30, 50, 50]))
    parms.set_plain_modulus(PlainModulusValue := 1032193)
    ctx = SealContext(parms)
    print_parameters(ctx)

    print("modulus switching chain (key level -> last):")
    cd = ctx.key_context_data()
    while cd is not None:
        print(
            f"  chain_index {cd.chain_index}: L={len(cd.parms.coeff_modulus)} "
            f"parms_id={cd.parms_id[0]:#x}..."
        )
        cd = cd.next_context_data

    keygen = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=keygen.public_key())
    dec = Decryptor(ctx, keygen.secret_key)
    ev = Evaluator(ctx)
    rk = keygen.relin_keys()

    ct = enc.encrypt(Plaintext.from_hex("5x^2 + 3x^1 + 1"))
    print(f"fresh budget: {dec.invariant_noise_budget(ct)} bits")
    sq = ev.relinearize(ev.square(ct), rk)
    print(f"after square: {dec.invariant_noise_budget(sq)} bits")
    switched = ev.mod_switch_to_next(sq)
    print(f"after mod_switch_to_next: {dec.invariant_noise_budget(switched)} bits")
    sq2 = ev.relinearize(ev.square(switched), rk)
    switched2 = ev.mod_switch_to_next(sq2)
    print(f"after 2nd square+switch: {dec.invariant_noise_budget(switched2)} bits")
    out = dec.decrypt(switched2)
    print(f"decrypted degree: {out.significant_coeff_count() - 1} (expected 8)")
    assert out.significant_coeff_count() - 1 == 8
    print("ex3 OK")


if __name__ == "__main__":
    main()
