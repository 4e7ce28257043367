"""Shared helpers for the example programs (reference: native/examples/examples.h)."""

import os
import sys

# allow running straight from a repo checkout without pip install
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gemini_seal import compile_cache  # noqa: E402

compile_cache.enable()


def print_parameters(context):
    cd = context.key_context_data()
    parms = cd.parms
    print("/")
    print("| Encryption parameters :")
    print(f"|   scheme: {parms.scheme.name}")
    print(f"|   poly_modulus_degree: {parms.poly_modulus_degree}")
    bits = [m.bit_count for m in parms.coeff_modulus]
    print(f"|   coeff_modulus size: {sum(bits)} ({' + '.join(map(str, bits))}) bits")
    if parms.scheme.name == "BFV":
        print(f"|   plain_modulus: {parms.plain_modulus.value}")
    print("\\")


def print_vector(vec, count=8):
    vals = list(vec)[:count]
    body = ", ".join(
        f"{v:.4f}" if isinstance(v, float) else str(v) for v in vals
    )
    print(f"    [ {body}, ... ]")
