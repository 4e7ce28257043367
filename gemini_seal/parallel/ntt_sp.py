"""Coefficient-sharded (sequence-parallel) negacyclic NTT over a device mesh.

No analogue in the reference — its NTT is in-core (SURVEY §2.4 "NTT-SP").
This shards the coefficient axis N over a mesh axis and runs the SAME
Harvey/Shoup lazy butterflies as ops.ntt (bit-exact), with the classic
hypercube-FFT communication structure:

- forward: the first log2(C) stages have butterfly distance h >= chunk, so
  partners live on other devices — each stage is one `ppermute` chunk
  exchange with the XOR-partner + a local butterfly half; the remaining
  stages are device-local (distance < chunk).
- inverse: mirrored — local stages first, the last log2(C) stages exchange.

Both halves compute the Shoup product redundantly instead of a second
exchange (compute is cheaper than a second interconnect hop).  Twiddle tables are
replicated host constants; each device gathers its (stage, group) slice.

Layout contract: `x` is the GLOBAL [..., L, N] array sharded on the last
axis in C contiguous chunks; outputs keep the same sharding and match
ops.ntt.ntt_forward/ntt_inverse exactly (same scrambled order, same
canonical range).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import modops


def shard_map(f, mesh, in_specs, out_specs):
    """``jax.shard_map`` without the varying-manual-axes check."""
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)

__all__ = ["ntt_forward_sharded", "ntt_inverse_sharded",
           "ntt_forward_sharded_4step", "ntt_inverse_sharded_4step"]


def _butterfly_fwd(x0, x1, w, ws, p, two_p):
    x0 = jnp.where(x0 >= two_p, x0 - two_p, x0)
    v = modops.mul_mod_shoup_lazy(x1, w, ws, p)
    return x0 + v, x0 - v + two_p


def _local_forward_stages(x, tables, first_stage, d, chunks):
    """Stages [first_stage, log_n) are chunk-local; twiddle groups are a
    dynamic slice at the device's group offset."""
    n = tables.coeff_count
    log_n = tables.coeff_count_power
    L = x.shape[-2]
    chunk = n // chunks
    batch = x.shape[:-1]
    p = tables.modulus.reshape(-1, 1, 1)
    two_p = p * np.uint64(2)
    w_all = tables.root_powers
    ws_all = tables.scaled_root_powers

    for s in range(first_stage, log_n):
        m = 1 << s
        h = n >> (s + 1)
        local_groups = max(m // chunks, 1)
        # device d holds groups [d*local_groups, (d+1)*local_groups)
        w = jax.lax.dynamic_slice_in_dim(
            w_all[:, m : 2 * m], d * local_groups, local_groups, axis=1
        )[:, :, None]
        ws = jax.lax.dynamic_slice_in_dim(
            ws_all[:, m : 2 * m], d * local_groups, local_groups, axis=1
        )[:, :, None]
        xr = x.reshape(batch[:-1] + (L, local_groups, 2, h))
        y0, y1 = _butterfly_fwd(xr[..., 0, :], xr[..., 1, :], w, ws, p, two_p)
        x = jnp.stack([y0, y1], axis=-2).reshape(batch + (chunk,))
    return x


def ntt_forward_sharded(x, tables, mesh: Mesh, coeff_axis: str = "coeff"):
    """Forward negacyclic NTT with the coefficient axis sharded over
    `mesh[coeff_axis]`; canonical output in [0, p), bit-exact vs
    ops.ntt.ntt_forward."""
    C = mesh.shape[coeff_axis]
    n = tables.coeff_count
    log_c = C.bit_length() - 1
    if C & (C - 1):
        raise ValueError("coeff axis size must be a power of two")
    if n % C or n // C < 2:
        raise ValueError("chunk too small for the mesh")
    w_all = tables.root_powers
    ws_all = tables.scaled_root_powers

    def local(xl):
        # xl: [..., L, chunk] local shard
        d = jax.lax.axis_index(coeff_axis)
        p = tables.modulus.reshape(-1, 1)
        two_p = p * np.uint64(2)
        x = xl
        for s in range(log_c):
            m = 1 << s
            cd = C >> (s + 1)            # partner offset in chunks
            perm = [(i, i ^ cd) for i in range(C)]
            other = jax.lax.ppermute(x, coeff_axis, perm)
            is_lower = (d & cd) == 0
            g = d >> (log_c - s)         # global group index (m groups)
            w = jax.lax.dynamic_slice_in_dim(w_all, m + g, 1, axis=1)
            ws = jax.lax.dynamic_slice_in_dim(ws_all, m + g, 1, axis=1)
            x0 = jnp.where(is_lower, x, other)
            x1 = jnp.where(is_lower, other, x)
            x0 = jnp.where(x0 >= two_p, x0 - two_p, x0)
            v = modops.mul_mod_shoup_lazy(x1, w, ws, p)
            x = jnp.where(is_lower, x0 + v, x0 - v + two_p)
        x = _local_forward_stages(x, tables, log_c, d, C)
        return modops.reduce_twice(x, p)

    spec_in = P(*([None] * (x.ndim - 1) + [coeff_axis]))
    fn = shard_map(local, mesh, (spec_in,), spec_in)
    return fn(x)


def ntt_inverse_sharded(x, tables, mesh: Mesh, coeff_axis: str = "coeff"):
    """Inverse negacyclic NTT, coefficient-sharded; canonical output in
    [0, p), bit-exact vs ops.ntt.ntt_inverse."""
    C = mesh.shape[coeff_axis]
    n = tables.coeff_count
    log_n = tables.coeff_count_power
    log_c = C.bit_length() - 1
    if C & (C - 1):
        raise ValueError("coeff axis size must be a power of two")
    if n % C or n // C < 2:
        raise ValueError("chunk too small for the mesh")
    chunk = n // C
    w_all = tables.inv_root_powers
    ws_all = tables.scaled_inv_root_powers
    inv_n = tables.inv_degree_modulo.reshape(-1, 1)
    inv_n_s = tables.scaled_inv_degree.reshape(-1, 1)

    # sequential-twiddle offsets per stage (ops.ntt walks ofs += m)
    offsets = []
    ofs = 1
    for s in range(log_n):
        offsets.append(ofs)
        ofs += n >> (s + 1)

    def local(xl):
        d = jax.lax.axis_index(coeff_axis)
        p = tables.modulus.reshape(-1, 1)
        two_p = p * np.uint64(2)
        L = xl.shape[-2]
        batch = xl.shape[:-1]
        x = xl

        # local stages: s in [0, log_n - log_c)
        p3 = tables.modulus.reshape(-1, 1, 1)
        two_p3 = p3 * np.uint64(2)
        for s in range(log_n - log_c):
            m = n >> (s + 1)
            h = 1 << s
            local_groups = m // C
            w = jax.lax.dynamic_slice_in_dim(
                w_all[:, offsets[s] : offsets[s] + m],
                d * local_groups, local_groups, axis=1,
            )[:, :, None]
            ws = jax.lax.dynamic_slice_in_dim(
                ws_all[:, offsets[s] : offsets[s] + m],
                d * local_groups, local_groups, axis=1,
            )[:, :, None]
            xr = x.reshape(batch[:-1] + (L, local_groups, 2, h))
            x0 = xr[..., 0, :]
            x1 = xr[..., 1, :]
            t = x0 + x1
            t = jnp.where(t >= two_p3, t - two_p3, t)
            dd = x0 - x1 + two_p3
            y1 = modops.mul_mod_shoup_lazy(dd, w, ws, p3)
            x = jnp.stack([t, y1], axis=-2).reshape(batch + (chunk,))

        # cross-device stages: s in [log_n - log_c, log_n)
        for s in range(log_n - log_c, log_n):
            m = n >> (s + 1)             # groups (= C >> ...)
            cd = (1 << s) // chunk       # partner offset in chunks
            perm = [(i, i ^ cd) for i in range(C)]
            other = jax.lax.ppermute(x, coeff_axis, perm)
            is_lower = (d & cd) == 0
            g = d // (2 * cd)
            w = jax.lax.dynamic_slice_in_dim(
                w_all[:, offsets[s] : offsets[s] + m], g, 1, axis=1
            )
            ws = jax.lax.dynamic_slice_in_dim(
                ws_all[:, offsets[s] : offsets[s] + m], g, 1, axis=1
            )
            x0 = jnp.where(is_lower, x, other)
            x1 = jnp.where(is_lower, other, x)
            t = x0 + x1
            t = jnp.where(t >= two_p, t - two_p, t)
            dd = x0 - x1 + two_p
            if m == 1:
                # BackwardLazyLast: fold n^{-1} into the kept lane
                t = modops.mul_mod_shoup_lazy(t, inv_n, inv_n_s, p)
            y1 = modops.mul_mod_shoup_lazy(dd, w, ws, p)
            x = jnp.where(is_lower, t, y1)
        return modops.reduce_once(x, p)

    spec_in = P(*([None] * (x.ndim - 1) + [coeff_axis]))
    fn = shard_map(local, mesh, (spec_in,), spec_in)
    return fn(x)


# ---------------------------------------------------------------------------
# Four-step / Bailey variant: ONE all_to_all transpose instead of log2(C)
# ppermute rounds (SURVEY §5: a four-step NTT with the transpose realized
# as one all_to_all over the interconnect).
#
# View the global array as X[C, chunk] (row = device).  The cross-device
# stages' butterflies pair ROWS with twiddles that depend only on the row
# group — so after an all_to_all transpose every cross stage is local (and
# each butterfly is computed once, not redundantly on both partners).
# Communication: 2 full-volume all_to_alls vs log2(C) full-volume
# ppermutes; compute: no duplicated Shoup products.
# ---------------------------------------------------------------------------

def _transpose_blocks(x, coeff_axis):
    """all_to_all turning [..., C_blocks, cc] block-column layout into
    [..., C_rows, cc] source-row layout (an involution)."""
    return jax.lax.all_to_all(
        x, coeff_axis, split_axis=x.ndim - 2, concat_axis=x.ndim - 2
    )


def forward_4step_local(xl, tables, C: int, coeff_axis: str,
                        lazy: bool = False):
    """The four-step forward body, callable INSIDE an enclosing shard_map
    (composed coeff-sharded pipelines, parallel/pipeline_csp.py).

    xl: this device's [..., L, chunk] shard.  lazy=True returns the
    [0, 4p) range (ops.ntt.ntt_forward_lazy contract), else canonical."""
    n = tables.coeff_count
    log_c = C.bit_length() - 1
    chunk = n // C
    cc = chunk // C
    w_all = tables.root_powers
    ws_all = tables.scaled_root_powers
    d = jax.lax.axis_index(coeff_axis)
    p1 = tables.modulus.reshape(-1, 1)
    # broadcast against the grouped row view [..., L, m, rows_h, cc]
    p4 = tables.modulus.reshape(-1, 1, 1, 1)
    two_p4 = p4 * np.uint64(2)
    batch = xl.shape[:-1]
    L = xl.shape[-2]

    # transpose in: rows become the C axis locally
    y = _transpose_blocks(xl.reshape(batch + (C, cc)), coeff_axis)
    # cross stages, now local over the row axis
    for s in range(log_c):
        m = 1 << s
        rows_h = C >> (s + 1)          # rows per half-group
        w = w_all[:, m : 2 * m][:, :, None, None]
        ws = ws_all[:, m : 2 * m][:, :, None, None]
        yr = y.reshape(batch[:-1] + (L, m, 2, rows_h, cc))
        x0 = yr[..., 0, :, :]
        x1 = yr[..., 1, :, :]
        x0 = jnp.where(x0 >= two_p4, x0 - two_p4, x0)
        v = modops.mul_mod_shoup_lazy(x1, w, ws, p4)
        y = jnp.stack([x0 + v, x0 - v + two_p4], axis=-3).reshape(
            batch + (C, cc)
        )
    # transpose back, then the chunk-local stages
    x2 = _transpose_blocks(y, coeff_axis).reshape(batch + (chunk,))
    x2 = _local_forward_stages(x2, tables, log_c, d, C)
    return x2 if lazy else modops.reduce_twice(x2, p1)


def _check_4step(n, C):
    if C & (C - 1):
        raise ValueError("coeff axis size must be a power of two")
    if n % C or n // C < C:
        raise ValueError("need chunk >= C for the block transpose")


def ntt_forward_sharded_4step(x, tables, mesh: Mesh, coeff_axis: str = "coeff"):
    """Forward NTT, coefficient-sharded, four-step communication schedule.

    Bit-exact vs ops.ntt.ntt_forward (identical butterfly dataflow; only
    the communication pattern differs from ntt_forward_sharded)."""
    C = mesh.shape[coeff_axis]
    _check_4step(tables.coeff_count, C)

    def local(xl):
        return forward_4step_local(xl, tables, C, coeff_axis)

    spec_in = P(*([None] * (x.ndim - 1) + [coeff_axis]))
    fn = shard_map(local, mesh, (spec_in,), spec_in)
    return fn(x)


def inverse_4step_local(xl, tables, C: int, coeff_axis: str,
                        lazy: bool = False):
    """The four-step inverse body, callable INSIDE an enclosing shard_map
    (composed coeff-sharded pipelines, parallel/pipeline_csp.py).

    xl: this device's [..., L, chunk] shard, input in [0, 2p).
    lazy=True returns [0, 2p) (ops.ntt.ntt_inverse_lazy contract)."""
    n = tables.coeff_count
    log_n = tables.coeff_count_power
    log_c = C.bit_length() - 1
    chunk = n // C
    cc = chunk // C
    w_all = tables.inv_root_powers
    ws_all = tables.scaled_inv_root_powers
    inv_n = tables.inv_degree_modulo.reshape(-1, 1, 1, 1)
    inv_n_s = tables.scaled_inv_degree.reshape(-1, 1, 1, 1)

    offsets = []
    ofs = 1
    for s in range(log_n):
        offsets.append(ofs)
        ofs += n >> (s + 1)

    d = jax.lax.axis_index(coeff_axis)
    p1 = tables.modulus.reshape(-1, 1)
    p3 = tables.modulus.reshape(-1, 1, 1)
    two_p3 = p3 * np.uint64(2)
    p4 = tables.modulus.reshape(-1, 1, 1, 1)
    two_p4 = p4 * np.uint64(2)
    L = xl.shape[-2]
    batch = xl.shape[:-1]
    x2 = xl

    # chunk-local stages first (identical to ntt_inverse_sharded)
    for s in range(log_n - log_c):
        m = n >> (s + 1)
        h = 1 << s
        local_groups = m // C
        w = jax.lax.dynamic_slice_in_dim(
            w_all[:, offsets[s] : offsets[s] + m],
            d * local_groups, local_groups, axis=1,
        )[:, :, None]
        ws = jax.lax.dynamic_slice_in_dim(
            ws_all[:, offsets[s] : offsets[s] + m],
            d * local_groups, local_groups, axis=1,
        )[:, :, None]
        xr = x2.reshape(batch[:-1] + (L, local_groups, 2, h))
        x0 = xr[..., 0, :]
        x1 = xr[..., 1, :]
        t = x0 + x1
        t = jnp.where(t >= two_p3, t - two_p3, t)
        dd = x0 - x1 + two_p3
        y1 = modops.mul_mod_shoup_lazy(dd, w, ws, p3)
        x2 = jnp.stack([t, y1], axis=-2).reshape(batch + (chunk,))

    # transpose in; last log_c stages act over the row axis
    y = _transpose_blocks(x2.reshape(batch + (C, cc)), coeff_axis)
    for s in range(log_n - log_c, log_n):
        m = n >> (s + 1)               # groups over rows
        rows_h = C // (2 * m)
        w = w_all[:, offsets[s] : offsets[s] + m][:, :, None, None]
        ws = ws_all[:, offsets[s] : offsets[s] + m][:, :, None, None]
        yr = y.reshape(batch[:-1] + (L, m, 2, rows_h, cc))
        x0 = yr[..., 0, :, :]
        x1 = yr[..., 1, :, :]
        t = x0 + x1
        t = jnp.where(t >= two_p4, t - two_p4, t)
        dd = x0 - x1 + two_p4
        if m == 1:
            t = modops.mul_mod_shoup_lazy(t, inv_n, inv_n_s, p4)
        y1 = modops.mul_mod_shoup_lazy(dd, w, ws, p4)
        y = jnp.stack([t, y1], axis=-3).reshape(batch + (C, cc))
    out = _transpose_blocks(y, coeff_axis).reshape(batch + (chunk,))
    return out if lazy else modops.reduce_once(out, p1)


def ntt_inverse_sharded_4step(x, tables, mesh: Mesh, coeff_axis: str = "coeff"):
    """Inverse NTT, coefficient-sharded, four-step communication schedule;
    bit-exact vs ops.ntt.ntt_inverse."""
    C = mesh.shape[coeff_axis]
    _check_4step(tables.coeff_count, C)

    def local(xl):
        return inverse_4step_local(xl, tables, C, coeff_axis)

    spec_in = P(*([None] * (x.ndim - 1) + [coeff_axis]))
    fn = shard_map(local, mesh, (spec_in,), spec_in)
    return fn(x)
