"""Example 7: performance test (reference: native/examples/7_performance.cpp).

Times each operation per scheme, averaged over `count` runs, for a sweep of
poly_modulus_degrees.  Device-plane timing excludes a jit warm-up; the
steady-state numbers are what count (the reference's methodology is a plain
wall-clock average too).

Usage: python ex7_performance.py [--n 4096] [--count 10]
"""

import argparse
import time

from common import print_parameters

import jax

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
    Plaintext,
    SchemeType,
    SealContext,
)


def timeit(fn, count):
    fn()  # warm-up (jit compile)
    t0 = time.perf_counter()
    for _ in range(count):
        out = fn()
    if hasattr(out, "data") and hasattr(out.data, "block_until_ready"):
        out.data.block_until_ready()  # device plane; host plane is eager numpy
    dt = (time.perf_counter() - t0) / count
    return dt * 1e6


def bfv_performance(n, count):
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.bfv_default(n))
    parms.set_plain_modulus(PlainModulus.batching(n, 20))
    ctx = SealContext(parms)
    print_parameters(ctx)

    t0 = time.perf_counter()
    keygen = KeyGenerator(ctx)
    pk = keygen.public_key()
    print(f"keygen (sk+pk): {(time.perf_counter()-t0)*1e6:.0f} us")
    use_ks = ctx.using_keyswitching
    rk = keygen.relin_keys() if use_ks else None
    gk = keygen.galois_keys() if use_ks else None
    enc = Encryptor(ctx, public_key=pk, secret_key=keygen.secret_key)
    dec = Decryptor(ctx, keygen.secret_key)
    ev = Evaluator(ctx)
    be = BatchEncoder(ctx)

    vals = list(range(be.slot_count))
    plain = be.encode(vals)
    ct1 = enc.encrypt(plain)
    ct2 = enc.encrypt(be.encode(vals[::-1]))

    results = {
        "encode": timeit(lambda: be.encode(vals), count),
        "decode": timeit(lambda: be.decode(dec.decrypt(ct1)), count),
        "encrypt": timeit(lambda: enc.encrypt(plain), count),
        "decrypt": timeit(lambda: dec.decrypt(ct1), count),
        "add": timeit(lambda: ev.add(ct1, ct2), count),
        "multiply": timeit(lambda: ev.multiply(ct1, ct2), count),
        "multiply_plain": timeit(lambda: ev.multiply_plain(ct1, plain), count),
        "square": timeit(lambda: ev.square(ct1), count),
    }
    if use_ks:
        results.update({
            "relinearize": timeit(
                lambda: ev.relinearize(ev.multiply(ct1, ct2), rk), count
            ),
            "rotate_rows_one_step": timeit(
                lambda: ev.rotate_rows(ct1, 1, gk), count
            ),
            "rotate_columns": timeit(lambda: ev.rotate_columns(ct1, gk), count),
        })
    for op, us in results.items():
        print(f"  {op:24s}: {us:10.0f} us")


def ckks_performance(n, count):
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    bits = CoeffModulus.max_bit_count(n) // 2
    sizes = {1024: [27], 2048: [54], 4096: [36, 36, 37], 8192: [43, 43, 44, 44, 44], 16384: [48, 48, 48, 49, 49, 49, 49, 49, 49]}
    parms.set_coeff_modulus(CoeffModulus.create(n, sizes.get(n, [40, 40, 40])))
    ctx = SealContext(parms)
    print_parameters(ctx)

    keygen = KeyGenerator(ctx)
    use_ks = ctx.using_keyswitching
    rk = keygen.relin_keys() if use_ks else None
    gk = keygen.galois_keys() if use_ks else None
    enc = Encryptor(ctx, public_key=keygen.public_key())
    dec = Decryptor(ctx, keygen.secret_key)
    ev = Evaluator(ctx)
    encoder = CKKSEncoder(ctx)

    # values in [0, 1) and a scale whose square stays under even the
    # smallest sweep size's single-prime modulus (2048 -> 54 bits)
    scale = 2.0 ** 25
    vals = [i / encoder.slot_count for i in range(encoder.slot_count)]
    plain = encoder.encode(vals, scale)
    ct1 = enc.encrypt(plain)
    ct2 = enc.encrypt(encoder.encode(vals[::-1], scale))

    results = {
        "encode": timeit(lambda: encoder.encode(vals, scale), count),
        "decode": timeit(lambda: encoder.decode(dec.decrypt(ct1)), count),
        "encrypt": timeit(lambda: enc.encrypt(plain), count),
        "decrypt": timeit(lambda: dec.decrypt(ct1), count),
        "add": timeit(lambda: ev.add(ct1, ct2), count),
        "multiply": timeit(lambda: ev.multiply(ct1, ct2), count),
        "multiply_plain": timeit(lambda: ev.multiply_plain(ct1, plain), count),
        "square": timeit(lambda: ev.square(ct1), count),
    }
    if len(ctx.first_context_data().parms.coeff_modulus) > 1:
        results["rescale_to_next_raw"] = timeit(
            lambda: ev.rescale_to_next(ev.multiply(ct1, ct2)), count
        )
    if use_ks:
        results.update({
            "relinearize": timeit(
                lambda: ev.relinearize(ev.multiply(ct1, ct2), rk), count
            ),
            "rescale_to_next": timeit(
                lambda: ev.rescale_to_next(
                    ev.relinearize(ev.multiply(ct1, ct2), rk)
                ),
                count,
            ),
            "rotate_vector_one_step": timeit(
                lambda: ev.rotate_vector(ct1, 1, gk), count
            ),
            "complex_conjugate": timeit(
                lambda: ev.complex_conjugate(ct1, gk), count
            ),
        })
    for op, us in results.items():
        print(f"  {op:24s}: {us:10.0f} us")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--count", type=int, default=10)
    args = ap.parse_args()
    print(f"devices: {jax.devices()}")
    print("=== BFV performance ===")
    bfv_performance(args.n, args.count)
    print("=== CKKS performance ===")
    ckks_performance(args.n, args.count)


if __name__ == "__main__":
    main()
