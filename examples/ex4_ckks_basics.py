"""Example 4: CKKS basics (reference: native/examples/4_ckks_basics.cpp).

Evaluates pi*x^3 + 0.4*x + 1 on encrypted real slots, with rescaling and
scale/level alignment.  The fork's version sets n_special_primes(3); with
nsp=3 the usable first level drops two extra moduli and key switching
rescales by the product of three special primes.
"""

import math

from common import print_parameters, print_vector

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
    SecLevelType,
)


def main():
    parms = EncryptionParameters(SchemeType.CKKS)
    n = 8192
    # mirror the fork's 4_ckks_basics.cpp:72-75: three special primes,
    # Create(8192, {55, 40, 40, 50, 50, 50}), sec_level_type::none
    parms.set_poly_modulus_degree(n)
    parms.set_n_special_primes(3)
    parms.set_coeff_modulus(CoeffModulus.create(n, [55, 40, 40, 50, 50, 50]))
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    print_parameters(ctx)
    print(f"first level L = {len(ctx.first_context_data().parms.coeff_modulus)}")

    keygen = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=keygen.public_key())
    dec = Decryptor(ctx, keygen.secret_key)
    ev = Evaluator(ctx)
    encoder = CKKSEncoder(ctx)
    rk = keygen.relin_keys()

    scale = 2.0 ** 40  # reference: 4_ckks_basics.cpp scale = pow(2.0, 40)
    xs = [i / encoder.slot_count for i in range(encoder.slot_count)]
    x = enc.encrypt(encoder.encode(xs, scale))

    pi_plain = encoder.encode(3.14159265, scale)
    coeff_plain = encoder.encode(0.4, scale)
    one_plain = encoder.encode(1.0, scale)

    x_sq = ev.rescale_to_next(ev.relinearize(ev.square(x), rk))
    pi_x = ev.rescale_to_next(ev.multiply_plain(x, pi_plain))
    x3 = ev.rescale_to_next(ev.relinearize(ev.multiply(x_sq, pi_x), rk))

    c_x = ev.rescale_to_next(ev.multiply_plain(x, coeff_plain))

    # align levels and scales (the reference normalizes scales manually,
    # 4_ckks_basics.cpp "we fix the scales")
    c_x = ev.mod_switch_to(c_x, x3.parms_id)
    forced = float(2.0 ** round(math.log2(x3.scale)))
    x3.scale = forced
    c_x.scale = forced
    one = encoder.encode(1.0, forced, x3.parms_id)

    total = ev.add_plain(ev.add(x3, c_x), one)
    out = encoder.decode(dec.decrypt(total))
    expect = [3.14159265 * v ** 3 + 0.4 * v + 1.0 for v in xs]
    err = max(abs(a - b) for a, b in zip(out, expect))
    print_vector(out, 4)
    print(f"max error: {err:.2e}")
    assert err < 1e-2
    print("ex4 OK")


if __name__ == "__main__":
    main()
