"""NTT kernel tests.

Pinned known-answer values come from the reference's test suite
(reference: native/tests/seal/util/ntt.cpp:55-105) for the 60-bit prime
0xffffffffffc0001 — the bit-exactness anchors for table generation and the
forward transform.  Property tests check the transform against the naive
O(n^2) evaluation definition and the negacyclic convolution theorem.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from gemini_seal.ops import ntt as ntt_mod
from gemini_seal.ops.ntt import build_ntt_tables, ntt_forward, ntt_inverse
from gemini_seal.utils.numth import get_primes

P60 = 0xFFFFFFFFFFC0001


def naive_negacyclic_ntt(a, psi, p):
    """A[j] = a(psi^(2*bitrev(j)+1)) mod p (reference: ntt.cpp:284-291)."""
    n = len(a)
    log_n = n.bit_length() - 1
    out = []
    for j in range(n):
        rev = int(f"{j:0{log_n}b}"[::-1], 2) if log_n else 0
        x = pow(psi, 2 * rev + 1, p)
        acc = 0
        xp = 1
        for c in a:
            acc = (acc + c * xp) % p
            xp = (xp * x) % p
        out.append(acc)
    return out


def test_pinned_root_powers():
    t = build_ntt_tables(1, [P60])
    assert int(t.root_powers[0][0]) == 1
    assert int(t.root_powers[0][1]) == 288794978602139552

    t = build_ntt_tables(2, [P60])
    assert int(t.root_powers[0][0]) == 1
    assert int(t.root_powers[0][1]) == 288794978602139552
    assert int(t.root_powers[0][2]) == 178930308976060547
    assert int(t.root_powers[0][3]) == 748001537669050592


def test_pinned_forward_transform():
    t = build_ntt_tables(1, [P60])
    poly = jnp.asarray(np.array([[0, 0]], dtype=np.uint64))
    out = ntt_forward(poly, t)
    assert out.tolist() == [[0, 0]]

    poly = jnp.asarray(np.array([[1, 0]], dtype=np.uint64))
    out = ntt_forward(poly, t)
    assert out.tolist() == [[1, 1]]

    poly = jnp.asarray(np.array([[1, 1]], dtype=np.uint64))
    out = ntt_forward(poly, t)
    assert out.tolist() == [[288794978602139553, 864126526004445282]]


def test_forward_matches_naive():
    rng = np.random.default_rng(7)
    for log_n in (2, 3, 6):
        n = 1 << log_n
        t = build_ntt_tables(log_n, [P60])
        psi = int(t.roots[0])
        a = rng.integers(0, P60, size=n, dtype=np.uint64)
        out = ntt_forward(jnp.asarray(a[None, :]), t)[0]
        expect = naive_negacyclic_ntt([int(c) for c in a], psi, P60)
        assert [int(v) for v in out] == expect


def test_roundtrip_multi_limb():
    rng = np.random.default_rng(8)
    moduli = [P60, 0xFFFFEE001, 0x1FFFFE0001]
    log_n = 8
    n = 1 << log_n
    t = build_ntt_tables(log_n, moduli)
    a = np.stack(
        [rng.integers(0, m, size=n, dtype=np.uint64) for m in moduli]
    )  # [L, N]
    fwd = ntt_forward(jnp.asarray(a), t)
    back = ntt_inverse(fwd, t)
    assert np.array_equal(np.asarray(back), a)


def test_batch_axes():
    rng = np.random.default_rng(9)
    moduli = [0xFFFFEE001, 0xFFFFC4001]
    t = build_ntt_tables(5, moduli)
    a = np.stack(
        [
            np.stack([rng.integers(0, m, size=32, dtype=np.uint64) for m in moduli])
            for _ in range(3)
        ]
    )  # [3, L, N]
    fwd = ntt_forward(jnp.asarray(a), t)
    # batched == per-slice
    for i in range(3):
        single = ntt_forward(jnp.asarray(a[i]), t)
        assert np.array_equal(np.asarray(fwd[i]), np.asarray(single))
    back = ntt_inverse(fwd, t)
    assert np.array_equal(np.asarray(back), a)


def test_negacyclic_convolution_theorem():
    rng = np.random.default_rng(10)
    p = P60
    log_n, n = 4, 16
    t = build_ntt_tables(log_n, [p])
    a = rng.integers(0, p, size=n, dtype=np.uint64)
    b = rng.integers(0, p, size=n, dtype=np.uint64)
    fa = ntt_forward(jnp.asarray(a[None]), t)
    fb = ntt_forward(jnp.asarray(b[None]), t)
    from gemini_seal.ops import modops
    from gemini_seal.modulus import Modulus

    r0, r1, _ = Modulus(p).const_ratio
    prod = modops.mul_mod(fa, fb, jnp.uint64(p), jnp.uint64(r0), jnp.uint64(r1))
    c = ntt_inverse(prod, t)[0]
    # schoolbook negacyclic product
    expect = [0] * n
    for i in range(n):
        for j in range(n):
            k = i + j
            v = int(a[i]) * int(b[j])
            if k >= n:
                expect[k - n] = (expect[k - n] - v) % p
            else:
                expect[k] = (expect[k] + v) % p
    assert [int(v) for v in c] == expect


def test_lazy_ranges():
    rng = np.random.default_rng(11)
    p = (1 << 59) - 55  # not prime; range checks only need the bound
    moduli = [P60]
    t = build_ntt_tables(10, moduli)
    a = rng.integers(0, P60, size=1024, dtype=np.uint64)
    lazy = ntt_mod.ntt_forward_lazy(jnp.asarray(a[None]), t)
    assert int(np.max(np.asarray(lazy))) < 4 * P60
    inv_lazy = ntt_mod.ntt_inverse_lazy(
        jnp.asarray(np.asarray(ntt_forward(jnp.asarray(a[None]), t))), t
    )
    assert int(np.max(np.asarray(inv_lazy))) < 2 * P60


def test_large_n_60bit_roundtrip():
    """Regression: the fork's lazy forward butterfly overflows u64 for
    60-bit moduli at N >= 2048 (no conditional subtract on the accumulating
    lane); our upstream-Harvey-style entry reduction must stay exact."""
    rng = np.random.default_rng(77)
    t = build_ntt_tables(12, [P60])
    a = rng.integers(0, P60, size=(1, 4096), dtype=np.uint64)
    fwd = ntt_forward(jnp.asarray(a), t)
    back = ntt_inverse(fwd, t)
    assert np.array_equal(np.asarray(back), a)


@pytest.mark.parametrize("log_n", [12, 15])
def test_roundtrip_large_n(log_n):
    """Forward/inverse roundtrip and range contracts across the size sweep
    up to the fork's POLY_MOD_DEGREE_MAX=65536 neighborhood (59-bit prime,
    the fork's USER_MOD_BIT_COUNT_MAX)."""
    n = 1 << log_n
    primes = get_primes(2 * n, 59, 1)
    tables = build_ntt_tables(log_n, primes)
    rng = np.random.default_rng(log_n)
    x = np.stack([rng.integers(0, int(p), size=(n,), dtype=np.uint64)
                  for p in primes])
    fwd = np.asarray(ntt_forward(x, tables))
    p = np.asarray([int(q) for q in primes], dtype=np.uint64).reshape(-1, 1)
    assert (fwd < p).all()
    back = np.asarray(ntt_inverse(fwd, tables))
    np.testing.assert_array_equal(back, x)


def test_native_and_pure_paths_bit_identical(monkeypatch):
    """The native C++ host transform and the pure vectorized path must
    agree bit for bit in ALL four variants (the host suite otherwise
    exercises only whichever path is available)."""
    from gemini_seal.modulus import CoeffModulus
    from gemini_seal.ops import ntt as ntt_mod
    from gemini_seal.utils import native

    if not native.available():
        pytest.skip("native module unavailable")
    mods = CoeffModulus.create(1024, [50, 36])
    tabs = ntt_mod.build_ntt_tables(10, mods)
    rng = np.random.default_rng(17)
    x = np.stack(
        [rng.integers(0, 2 * m.value, (3, 1024), dtype=np.uint64) for m in mods],
        axis=1,
    )  # lazy [0, 2p) inputs
    fns = [
        ("fwd", ntt_mod.ntt_forward), ("fwd_lazy", ntt_mod.ntt_forward_lazy),
        ("inv", ntt_mod.ntt_inverse), ("inv_lazy", ntt_mod.ntt_inverse_lazy),
    ]
    got_native = {k: np.asarray(f(x, tabs)) for k, f in fns}
    monkeypatch.setattr(native, "available", lambda: False)
    got_pure = {k: np.asarray(f(x, tabs)) for k, f in fns}
    for k in got_native:
        assert np.array_equal(got_native[k], got_pure[k]), k


@pytest.mark.parametrize("log_n", [4, 11, 12, 13])
def test_fused_stage_pairs_bit_identical(log_n):
    """The fused two-stage (radix-4 view) device path must be bit-identical
    to per-stage radix-2 in all four variants, at odd AND even log_n (even
    log_n exercises the fused inverse pair that carries the n^{-1} fold)."""
    import jax

    from gemini_seal.modulus import CoeffModulus
    from gemini_seal.ops import ntt as ntt_mod

    n = 1 << log_n
    mods = CoeffModulus.create(max(n, 1024), [50, 40, 58])
    tabs = ntt_mod.build_ntt_tables(log_n, mods)
    rng = np.random.default_rng(23)
    x = np.stack(
        [rng.integers(0, 2 * m.value, (2, n), dtype=np.uint64) for m in mods],
        axis=1,
    )  # lazy [0, 2p) inputs, valid for every variant
    fns = [
        ("fwd", ntt_mod.ntt_forward), ("fwd_lazy", ntt_mod.ntt_forward_lazy),
        ("inv", ntt_mod.ntt_inverse), ("inv_lazy", ntt_mod.ntt_inverse_lazy),
    ]
    prev = ntt_mod.FUSE_STAGES
    got = {}
    try:
        for depth in (1, 2, 3, 4):
            ntt_mod.FUSE_STAGES = depth
            # jit forces the device path (host numpy would take the native
            # transform, which has no stage fusion to test)
            got[depth] = {
                k: np.asarray(jax.jit(lambda v, f=f: f(v, tabs))(x))
                for k, f in fns
            }
    finally:
        ntt_mod.FUSE_STAGES = prev
    for depth in (2, 3, 4):
        for k in got[depth]:
            assert np.array_equal(got[1][k], got[depth][k]), (depth, k)


def test_default_fuse_depth_round_trips(monkeypatch):
    """The default depth follows the platform: 3 on the GPU (the k measured
    fastest on the headline step, PERF.md's k sweep), 2 on the CPU and on
    the host plane; an int in FUSE_STAGES overrides both.  At the default
    the device transforms still invert each other exactly, with the lazy
    forward output in [0, 4p)."""
    import jax
    import jax.numpy as jnp

    from gemini_seal.modulus import CoeffModulus

    assert ntt_mod.FUSE_STAGES is None
    host, dev = np.zeros(4, np.uint64), jnp.zeros(4, jnp.uint64)
    assert ntt_mod.fuse_depth(host) == 2
    assert ntt_mod.fuse_depth(dev) == 2
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert ntt_mod.fuse_depth(dev) == 3
    assert ntt_mod.fuse_depth(host) == 2
    monkeypatch.setattr(ntt_mod, "FUSE_STAGES", 4)
    assert ntt_mod.fuse_depth(dev) == ntt_mod.fuse_depth(host) == 4
    monkeypatch.undo()

    log_n = 10
    mods = CoeffModulus.create(1 << log_n, [50, 40, 58])
    tabs = ntt_mod.build_ntt_tables(log_n, mods)
    rng = np.random.default_rng(5)
    x = np.stack([rng.integers(0, m.value, (2, 1 << log_n), dtype=np.uint64)
                  for m in mods], axis=1)
    lazy = np.asarray(jax.jit(lambda v: ntt_mod.ntt_forward_lazy(v, tabs))(x))
    p = np.array([m.value for m in mods], dtype=np.uint64)[:, None]
    assert np.all(lazy < 4 * p)
    fwd = np.asarray(jax.jit(lambda v: ntt_mod.ntt_forward(v, tabs))(x))
    assert np.array_equal(fwd, lazy % p)
    back = np.asarray(jax.jit(lambda v: ntt_mod.ntt_inverse(v, tabs))(fwd))
    assert np.array_equal(back, x)
