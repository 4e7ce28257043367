"""The device's measured basis for the u64 kernels, on one GPU.

Two numbers that bound every kernel of the device plane:

- ``mul_mod_shoup_lazy`` (ops/modops.py) in G mulmod/s, on a chain of
  dependent Shoup products that XLA fuses into one elementwise kernel,
  so the rate is arithmetic-bound;
- a large u64 copy (read + write) in GB/s, the memory-bound side.

Every timed call ends in ``block_until_ready`` on its real output.

    python tools/bench_modops.py [--elems 67108864] [--chain 32]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--elems", type=int, default=1 << 26)
    ap.add_argument("--chain", type=int, default=32)
    cfg = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from gemini_seal import compile_cache
    from gemini_seal.devices import card_line, require_gpu, time_calls
    from gemini_seal.modulus import CoeffModulus
    from gemini_seal.ops.modops import mul_mod_shoup_lazy

    require_gpu(jax.default_backend(), "bench_modops.py")
    compile_cache.enable()
    print(f"card: {card_line()}; {jax.devices()[0].device_kind}", flush=True)

    p = CoeffModulus.create(8192, [50])[0].value
    w = 0x123456789AB % p
    w_shoup = ((w << 64) // p) & 0xFFFFFFFFFFFFFFFF
    rng = np.random.default_rng(0)
    x = jax.device_put(rng.integers(0, p, cfg.elems, dtype=np.uint64))
    pw = (np.uint64(p), np.uint64(w), np.uint64(w_shoup))

    def chain(v):
        pp, ww, ws = (jnp.uint64(c) for c in pw)
        for _ in range(cfg.chain):
            v = mul_mod_shoup_lazy(v, ww, ws, pp)
        return v

    step = jax.jit(chain)
    got = np.asarray(step(x))[:1024]
    want = np.asarray(x)[:1024].astype(object)
    for _ in range(cfg.chain):
        want = (want * w) % p
    if not np.array_equal(got.astype(object) % p, want):
        raise AssertionError("mul_mod_shoup_lazy chain differs from host")
    per = time_calls(step, (x,), min_seconds=3.0)
    print(json.dumps({"kernel": "mul_mod_shoup_lazy", "elems": cfg.elems,
                      "chain": cfg.chain,
                      "g_mulmod_per_s": cfg.elems * cfg.chain / per / 1e9}),
          flush=True)

    copy = jax.jit(lambda v: v + jnp.uint64(1))
    per = time_calls(copy, (x,), min_seconds=3.0)
    print(json.dumps({"kernel": "u64_copy", "elems": cfg.elems,
                      "gb_per_s": 2 * 8 * cfg.elems / per / 1e9}),
          flush=True)


if __name__ == "__main__":
    main()
