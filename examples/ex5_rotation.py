"""Example 5: rotation (reference: native/examples/5_rotation.cpp).

BFV batched row/column rotations and CKKS vector rotations with Galois keys.
The fork's version sets n_special_primes(1) (5_rotation.cpp:135).
"""

from common import print_parameters, print_vector

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
    SchemeType,
    SealContext,
    SecLevelType,
)


def bfv_rotation_demo():
    print("--- BFV rotation ---")
    parms = EncryptionParameters(SchemeType.BFV)
    n = 4096
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.bfv_default(n))
    parms.set_plain_modulus(PlainModulus.batching(n, 20))
    parms.set_n_special_primes(1)
    ctx = SealContext(parms)
    print_parameters(ctx)

    keygen = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=keygen.public_key())
    dec = Decryptor(ctx, keygen.secret_key)
    ev = Evaluator(ctx)
    be = BatchEncoder(ctx)
    gk = keygen.galois_keys()

    row = be.slot_count // 2
    mat = [0] * be.slot_count
    mat[0], mat[1], mat[2], mat[3] = 1, 2, 3, 4
    ct = enc.encrypt(be.encode(mat))

    rot3 = ev.rotate_rows(ct, 3, gk)
    out = be.decode(dec.decrypt(rot3))
    print("rows rotated by 3:")
    print_vector(out)
    assert out[0] == 4 and out[row - 3] == 1

    cols = ev.rotate_columns(ct, gk)
    out2 = be.decode(dec.decrypt(cols))
    assert out2[row] == 1 and out2[row + 1] == 2
    print("columns swapped OK")


def ckks_rotation_demo():
    print("--- CKKS rotation ---")
    parms = EncryptionParameters(SchemeType.CKKS)
    # mirror the fork's 5_rotation.cpp:133-136: n_special_primes(1),
    # Create(8192, {40, 40, 40, 40, 50, 50})
    n = 8192
    parms.set_poly_modulus_degree(n)
    parms.set_n_special_primes(1)
    parms.set_coeff_modulus(CoeffModulus.create(n, [40, 40, 40, 40, 50, 50]))
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    keygen = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=keygen.public_key())
    dec = Decryptor(ctx, keygen.secret_key)
    ev = Evaluator(ctx)
    encoder = CKKSEncoder(ctx)
    gk = keygen.galois_keys()

    vals = [i * 0.01 for i in range(encoder.slot_count)]
    ct = enc.encrypt(encoder.encode(vals, 2.0 ** 30))
    rot = ev.rotate_vector(ct, 2, gk)
    out = encoder.decode(dec.decrypt(rot))
    assert abs(out[0] - vals[2]) < 1e-3
    print("vector rotated by 2 OK")
    conj = ev.complex_conjugate(ct, gk)
    out2 = encoder.decode(dec.decrypt(conj))
    assert abs(out2[1] - vals[1]) < 1e-3
    print("conjugate OK")


def main():
    bfv_rotation_demo()
    ckks_rotation_demo()
    print("ex5 OK")


if __name__ == "__main__":
    main()
