"""Coefficient-sharded NTT (sequence parallelism) is bit-exact vs the local
kernel on the virtual CPU mesh (no reference analogue — SURVEY §2.4 NTT-SP)."""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gemini_seal.ops.ntt import build_ntt_tables, ntt_forward, ntt_inverse
from gemini_seal.parallel.ntt_sp import ntt_forward_sharded, ntt_inverse_sharded
from gemini_seal.utils.numth import get_primes

RNG = np.random.default_rng(7)


def make_mesh(c):
    devs = jax.devices()[:c]
    return Mesh(np.asarray(devs), axis_names=("coeff",))


@pytest.mark.parametrize("c,log_n", [(2, 5), (4, 8), (8, 5)])
def test_forward_sharded_bit_exact(c, log_n):
    if len(jax.devices()) < c:
        pytest.skip("not enough devices")
    n = 1 << log_n
    primes = get_primes(2 * n, 50, 3)
    tables = build_ntt_tables(log_n, primes)
    x = np.stack([RNG.integers(0, int(p), size=(2, n), dtype=np.uint64)
                  for p in primes], axis=1)  # [2, L, n]
    want = np.asarray(ntt_forward(x, tables))
    mesh = make_mesh(c)
    sh = NamedSharding(mesh, P(None, None, "coeff"))
    got = np.asarray(ntt_forward_sharded(jax.device_put(x, sh), tables, mesh))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("c,log_n", [(2, 5), (4, 8), (8, 5)])
def test_inverse_sharded_bit_exact(c, log_n):
    if len(jax.devices()) < c:
        pytest.skip("not enough devices")
    n = 1 << log_n
    primes = get_primes(2 * n, 50, 2)
    tables = build_ntt_tables(log_n, primes)
    x = np.stack([RNG.integers(0, int(p), size=(n,), dtype=np.uint64)
                  for p in primes])  # [L, n]
    want = np.asarray(ntt_inverse(x, tables))
    mesh = make_mesh(c)
    sh = NamedSharding(mesh, P(None, "coeff"))
    got = np.asarray(ntt_inverse_sharded(jax.device_put(x, sh), tables, mesh))
    np.testing.assert_array_equal(got, want)


def test_roundtrip_sharded():
    if len(jax.devices()) < 4:
        pytest.skip("not enough devices")
    n = 256
    primes = get_primes(2 * n, 40, 2)
    tables = build_ntt_tables(8, primes)
    x = np.stack([RNG.integers(0, int(p), size=(n,), dtype=np.uint64)
                  for p in primes])
    mesh = make_mesh(4)
    sh = NamedSharding(mesh, P(None, "coeff"))
    fwd = ntt_forward_sharded(jax.device_put(x, sh), tables, mesh)
    back = np.asarray(ntt_inverse_sharded(fwd, tables, mesh))
    np.testing.assert_array_equal(back, x)


@pytest.mark.parametrize("c,log_n", [(2, 5), (4, 8)])
def test_forward_4step_bit_exact(c, log_n):
    from gemini_seal.parallel.ntt_sp import ntt_forward_sharded_4step

    if len(jax.devices()) < c:
        pytest.skip("not enough devices")
    n = 1 << log_n
    primes = get_primes(2 * n, 50, 2)
    tables = build_ntt_tables(log_n, primes)
    x = np.stack([RNG.integers(0, int(p), size=(2, n), dtype=np.uint64)
                  for p in primes], axis=1)
    want = np.asarray(ntt_forward(x, tables))
    mesh = make_mesh(c)
    sh = NamedSharding(mesh, P(None, None, "coeff"))
    got = np.asarray(
        ntt_forward_sharded_4step(jax.device_put(x, sh), tables, mesh)
    )
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("c,log_n", [(2, 5), (4, 8)])
def test_inverse_4step_bit_exact(c, log_n):
    from gemini_seal.parallel.ntt_sp import ntt_inverse_sharded_4step

    if len(jax.devices()) < c:
        pytest.skip("not enough devices")
    n = 1 << log_n
    primes = get_primes(2 * n, 50, 2)
    tables = build_ntt_tables(log_n, primes)
    x = np.stack([RNG.integers(0, int(p), size=(n,), dtype=np.uint64)
                  for p in primes])
    want = np.asarray(ntt_inverse(x, tables))
    mesh = make_mesh(c)
    sh = NamedSharding(mesh, P(None, "coeff"))
    got = np.asarray(
        ntt_inverse_sharded_4step(jax.device_put(x, sh), tables, mesh)
    )
    np.testing.assert_array_equal(got, want)


def test_compiled_collectives_present():
    """Guard against silent de-parallelization: the compiled programs must
    contain real collectives (hypercube: log2(C) collective-permute
    rounds; four-step: all-to-all transposes)."""
    from gemini_seal.parallel.ntt_sp import ntt_forward_sharded_4step

    if len(jax.devices()) < 4:
        pytest.skip("not enough devices")
    n, log_n, c = 256, 8, 4
    tables = build_ntt_tables(log_n, get_primes(2 * n, 50, 1))
    x = np.zeros((1, n), dtype=np.uint64)
    mesh = make_mesh(c)
    sh = NamedSharding(mesh, P(None, "coeff"))
    dx = jax.device_put(x, sh)

    f1 = jax.jit(lambda a: ntt_forward_sharded(a, tables, mesh))
    txt = f1.lower(dx).compile().as_text()
    assert txt.count("collective-permute") > 0

    f2 = jax.jit(lambda a: ntt_forward_sharded_4step(a, tables, mesh))
    txt = f2.lower(dx).compile().as_text()
    assert txt.count("all-to-all") > 0


def test_realistic_shape_sharded_ntt_bit_exact():
    """N=4096, L=8, 60-bit primes, C=8 — the realistic serving shape for
    both NTT-SP schedules (not only toy shapes); chunk
    boundaries and twiddle indexing change with N/C, so N=256 passes do
    not cover this."""
    from gemini_seal.parallel.ntt_sp import (
        ntt_forward_sharded_4step, ntt_inverse_sharded_4step,
    )

    if len(jax.devices()) < 8:
        pytest.skip("not enough devices")
    n, log_n, c = 4096, 12, 8
    primes = get_primes(2 * n, 60, 8)
    tables = build_ntt_tables(log_n, primes)
    x = np.stack([RNG.integers(0, int(p), size=(n,), dtype=np.uint64)
                  for p in primes])  # [8, n]
    want_f = np.asarray(ntt_forward(x, tables))
    mesh = make_mesh(c)
    sh = NamedSharding(mesh, P(None, "coeff"))
    dx = jax.device_put(x, sh)

    got_hyper = np.asarray(ntt_forward_sharded(dx, tables, mesh))
    np.testing.assert_array_equal(got_hyper, want_f)
    got_4step = np.asarray(ntt_forward_sharded_4step(dx, tables, mesh))
    np.testing.assert_array_equal(got_4step, want_f)

    want_i = np.asarray(ntt_inverse(x, tables))
    got_i = np.asarray(ntt_inverse_sharded(dx, tables, mesh))
    np.testing.assert_array_equal(got_i, want_i)
    got_i4 = np.asarray(ntt_inverse_sharded_4step(dx, tables, mesh))
    np.testing.assert_array_equal(got_i4, want_i)
