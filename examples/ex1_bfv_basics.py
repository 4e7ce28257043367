"""Example 1: BFV basics (reference: native/examples/1_bfv_basics.cpp).

Evaluates 4x^4 + 8x^3 + 8x^2 + 8x + 4 = 4(x^2+1)(x+1)^2 on an encrypted x,
watching the noise budget shrink through squarings.
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
    n = 4096
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.bfv_default(n))
    parms.set_plain_modulus(1024)
    ctx = SealContext(parms)
    print_parameters(ctx)

    keygen = KeyGenerator(ctx)
    pk = keygen.public_key()
    rk = keygen.relin_keys()
    enc = Encryptor(ctx, public_key=pk)
    ev = Evaluator(ctx)
    dec = Decryptor(ctx, keygen.secret_key)

    x = 6
    x_plain = Plaintext.from_hex(f"{x:x}")
    x_enc = enc.encrypt(x_plain)
    print(f"encrypt x = {x};  noise budget: {dec.invariant_noise_budget(x_enc)} bits")

    # (x^2 + 1)
    x_sq_plus_one = ev.add_plain(ev.relinearize(ev.square(x_enc), rk), Plaintext.from_hex("1"))
    print(f"x^2+1 noise budget: {dec.invariant_noise_budget(x_sq_plus_one)} bits")
    # (x + 1)^2
    x_plus_one = ev.add_plain(x_enc, Plaintext.from_hex("1"))
    x_plus_one_sq = ev.relinearize(ev.square(x_plus_one), rk)
    print(f"(x+1)^2 noise budget: {dec.invariant_noise_budget(x_plus_one_sq)} bits")
    # 4(x^2+1)(x+1)^2
    result = ev.multiply_plain(x_sq_plus_one, Plaintext.from_hex("4"))
    result = ev.relinearize(ev.multiply(result, x_plus_one_sq), rk)
    print(f"final noise budget: {dec.invariant_noise_budget(result)} bits")

    decrypted = dec.decrypt(result)
    expected = (4 * (x * x + 1) * (x + 1) ** 2) % 1024
    got = int(decrypted.data[0])
    print(f"decrypted constant term: {got} (expected {expected})")
    assert got == expected
    print("ex1 OK")


if __name__ == "__main__":
    main()
