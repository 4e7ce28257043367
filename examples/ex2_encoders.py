"""Example 2: encoders (reference: native/examples/2_encoders.cpp).

IntegerEncoder, BatchEncoder SIMD slots, and CKKSEncoder basics.
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
    IntegerEncoder,
    KeyGenerator,
    PlainModulus,
    SchemeType,
    SealContext,
)


def integer_encoder_demo():
    print("--- IntegerEncoder ---")
    parms = EncryptionParameters(SchemeType.BFV)
    n = 4096
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.bfv_default(n))
    parms.set_plain_modulus(512)
    ctx = SealContext(parms)
    keygen = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=keygen.public_key())
    dec = Decryptor(ctx, keygen.secret_key)
    ev = Evaluator(ctx)
    encoder = IntegerEncoder(ctx)

    v1, v2 = 5, -7
    c1 = enc.encrypt(encoder.encode(v1))
    c2 = enc.encrypt(encoder.encode(v2))
    total = ev.add(c1, c2)
    print(f"{v1} + {v2} = {encoder.decode(dec.decrypt(total))}")
    assert encoder.decode(dec.decrypt(total)) == -2


def batch_encoder_demo():
    print("--- BatchEncoder ---")
    parms = EncryptionParameters(SchemeType.BFV)
    n = 4096
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.bfv_default(n))
    parms.set_plain_modulus(PlainModulus.batching(n, 20))
    ctx = SealContext(parms)
    print_parameters(ctx)
    keygen = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=keygen.public_key())
    dec = Decryptor(ctx, keygen.secret_key)
    ev = Evaluator(ctx)
    be = BatchEncoder(ctx)
    print(f"slot count: {be.slot_count}")

    mat = [0] * be.slot_count
    mat[0], mat[1], mat[2], mat[3] = 1, 2, 3, 4
    ct = enc.encrypt(be.encode(mat))
    sq = ev.relinearize(ev.square(ct), keygen.relin_keys())
    out = be.decode(dec.decrypt(sq))
    print_vector(out)
    assert out[:4] == [1, 4, 9, 16]


def ckks_encoder_demo():
    print("--- CKKSEncoder ---")
    parms = EncryptionParameters(SchemeType.CKKS)
    n = 4096
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [40, 30, 30]))
    ctx = SealContext(parms)
    keygen = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=keygen.public_key())
    dec = Decryptor(ctx, keygen.secret_key)
    ev = Evaluator(ctx)
    encoder = CKKSEncoder(ctx)
    print(f"slot count: {encoder.slot_count}")

    vals = [0.0, 1.1, 2.2, 3.3]
    scale = 2.0 ** 30
    ct = enc.encrypt(encoder.encode(vals, scale))
    sq = ev.rescale_to_next(ev.relinearize(ev.square(ct), keygen.relin_keys()))
    out = encoder.decode(dec.decrypt(sq))
    print_vector(out, 4)
    assert all(abs(o - v * v) < 1e-2 for o, v in zip(out[:4], vals))


def main():
    integer_encoder_demo()
    batch_encoder_demo()
    ckks_encoder_demo()
    print("ex2 OK")


if __name__ == "__main__":
    main()
