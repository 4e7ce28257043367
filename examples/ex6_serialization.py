"""Example 6: serialization (reference: native/examples/6_serialization.cpp).

A client/server exchange through the SEAL wire format, including the zlib
deflate mode.
"""

import io

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
    SealContext,
)
from gemini_seal import serialization as ser


def main():
    # --- server chooses parameters and ships them ---
    parms = EncryptionParameters(SchemeType.CKKS)
    n = 4096
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [40, 30, 30]))
    parms_blob = ser.save(parms, ser.COMPR_DEFLATE)
    print(f"parameters wire size (deflate): {len(parms_blob)} bytes")

    # --- client loads them, makes keys, encrypts ---
    client_parms = ser.load_parms(parms_blob)
    client_ctx = SealContext(client_parms)
    print_parameters(client_ctx)
    keygen = KeyGenerator(client_ctx)
    enc = Encryptor(client_ctx, public_key=keygen.public_key())
    encoder = CKKSEncoder(client_ctx)
    scale = 2.0 ** 30
    ct = enc.encrypt(encoder.encode([3.14, 2.718], scale))
    ct_blob = ser.save(ct, ser.COMPR_DEFLATE)
    rk_blob = ser.save(keygen.relin_keys())
    print(f"ciphertext wire size (deflate): {len(ct_blob)} bytes")

    # --- server evaluates on the wire objects ---
    server_ctx = SealContext(ser.load_parms(parms_blob))
    ct_server = ser.load_ciphertext(ct_blob, server_ctx)
    rk_server = ser.load_relin_keys(rk_blob, server_ctx)
    ev = Evaluator(server_ctx)
    sq = ev.rescale_to_next(ev.relinearize(ev.square(ct_server), rk_server))
    result_blob = ser.save(sq)

    # --- client decrypts the result ---
    dec = Decryptor(client_ctx, keygen.secret_key)
    result = ser.load_ciphertext(result_blob, client_ctx)
    out = encoder.decode(dec.decrypt(result))
    print(f"squares: {out[0]:.4f}, {out[1]:.4f} (expect 9.8596, 7.3875)")
    assert abs(out[0] - 3.14 ** 2) < 1e-2 and abs(out[1] - 2.718 ** 2) < 1e-2
    print("ex6 OK")


if __name__ == "__main__":
    main()
