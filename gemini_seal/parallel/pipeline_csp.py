"""Coefficient-sharded (sequence-parallel) serving pipeline.

The NTT-SP transforms (parallel/ntt_sp.py) composed
END-TO-END.  For the deep-N latency regime (N = 32768/65536) the limb
axis saturates at C ≈ L; sharding the COEFFICIENT axis instead keeps
scaling: every non-NTT op of the hot step (dyadic products, mod-up
digit contraction over limbs, key inner product over bundles, rescale
corrections) is elementwise over N and therefore LOCAL under coefficient
sharding — the only communication is inside each NTT, where the
four-step/Bailey schedule costs exactly two all_to_all transposes
(SURVEY §5 long-context mapping; no reference analogue).

Implementation: ops.keyswitch and ops.rnsops take a pluggable NTT
strategy (keyswitch.NTTOps); this module passes the all_to_all four-step
local bodies and wraps the UNCHANGED in-core dataflow in one shard_map —
single-source math, bit-exact by construction (pinned by
tests/test_pipeline_csp.py against the in-core step).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import modops
from ..ops.keyswitch import (KeySwitchPlan, NTTOps, compute_modup_digits,
                             keyswitch_inner_product, switch_key)
from ..ops.rnsops import divide_and_round_q_last_ntt
from .keyswitch_sp import _jit_cached
from .ntt_sp import (_check_4step, forward_4step_local, inverse_4step_local,
                     shard_map)

__all__ = ["switch_key_coeff_sharded", "ckks_mul_relin_rescale_coeff_sharded",
           "ckks_rotate_coeff_sharded", "ckks_rotate_many_coeff_sharded"]


class _CoeffShardedNTT(NTTOps):
    """NTT strategy whose four entry points are the four-step all_to_all
    bodies, for use INSIDE a shard_map over `coeff_axis`."""

    def __init__(self, C: int, coeff_axis: str):
        self.forward = lambda x, t: forward_4step_local(x, t, C, coeff_axis)
        self.forward_lazy = lambda x, t: forward_4step_local(
            x, t, C, coeff_axis, lazy=True
        )
        self.inverse = lambda x, t: inverse_4step_local(x, t, C, coeff_axis)
        self.inverse_lazy = lambda x, t: inverse_4step_local(
            x, t, C, coeff_axis, lazy=True
        )


def _coeff_spec(nd: int, mesh: Mesh, coeff_axis: str, n_struct: int) -> P:
    """[batch..., <n_struct structural axes ending in N>] data: shard the
    last axis over `coeff_axis`, and 'dp' on the leading batch axis when
    the mesh has one and batch dims exist (n_struct = 2 for [L, N]
    targets, 3 for [size, L, N] ciphertexts)."""
    lead = [None] * (nd - 1)
    if "dp" in mesh.axis_names and nd > n_struct:
        lead[0] = "dp"
    return P(*(lead + [coeff_axis]))


def _galois_block_plan(galois_tool, elt: int, C: int):
    """The NTT-domain Galois permutation under C contiguous coefficient
    shards decomposes as ONE block exchange + a LOCAL gather.

    Why: output storage index s reads input index table[s] where, for
    s = b*B + t (block b, offset t), the bit-reversal algebra gives
    table[s] mod 2^c CONSTANT over the block — every output block sources
    from exactly one input block, and the block map is a bijection (the
    derivation: rev(s) has its low c bits fixed per block, the automorphism
    v = (elt*(2*rev(s)+1))>>1 preserves v mod 2^c across the block, and
    rev(v)'s top c bits depend only on v mod 2^c).  So the sharded
    automorphism is a single collective-permute + jnp.take — no all_to_all,
    no gather of the full axis.

    Returns (perm, lidx): perm = [(src_dev, dst_dev)] pairs (None if the
    block map is the identity), lidx = GLOBAL [N] local gather indices
    (shard P(coeff_axis) so each device receives its slice).
    """
    n = galois_tool.coeff_count
    if n % C != 0:
        raise ValueError("N not divisible by coeff shards")
    B = n // C
    table = galois_tool._ntt_table(elt)
    src_block = table.reshape(C, B) // B
    if not np.all(src_block == src_block[:, :1]):
        raise AssertionError("Galois block-locality violated")  # provably holds
    src = src_block[:, 0]
    if sorted(src.tolist()) != list(range(C)):
        raise AssertionError("Galois block map not bijective")
    perm = None if np.array_equal(src, np.arange(C)) else [
        (int(src[b]), b) for b in range(C)
    ]
    lidx = (table % B).astype(np.int64)
    return perm, lidx


def _permute_local(x_local, lidx_local, perm, coeff_axis: str):
    """Apply a block-planned Galois permutation to this device's shard."""
    y = x_local if perm is None else jax.lax.ppermute(
        x_local, coeff_axis, perm
    )
    return jnp.take(y, lidx_local, axis=-1)


def switch_key_coeff_sharded(target, key_vector_data, plan: KeySwitchPlan,
                             mesh: Mesh, is_ntt_form: bool = True,
                             coeff_axis: str = "coeff"):
    """Hybrid key switch with the COEFFICIENT axis sharded.

    target: GLOBAL u64[.., n_ct, N] sharded P(..., coeff_axis);
    key_vector_data: u64[nb, 2, L_key, N] sharded on N.  Returns (d0, d1)
    with the target's sharding — bit-exact vs ops.keyswitch.switch_key.
    Comm: 2 all_to_alls per NTT invocation, nothing else.
    """
    C = mesh.shape[coeff_axis]
    _check_4step(plan.ct_tables.coeff_count, C)
    nttops = _CoeffShardedNTT(C, coeff_axis)

    def f(tgt_local, key_local):
        return switch_key(tgt_local, key_local, plan, is_ntt_form, ntt=nttops)

    nd = target.ndim
    spec = _coeff_spec(nd, mesh, coeff_axis, 2)
    kspec = P(None, None, None, coeff_axis)

    def build():
        return shard_map(f, mesh, in_specs=(spec, kspec),
                         out_specs=(spec, spec))

    fn = _jit_cached(plan, mesh, ("csp_switch", is_ntt_form), nd, build)
    return fn(target, key_vector_data)


def ckks_mul_relin_rescale_coeff_sharded(a, b, key_vector_data,
                                         plan: KeySwitchPlan, mesh: Mesh,
                                         coeff_axis: str = "coeff"):
    """The full CKKS hot step (multiply + relinearize + rescale) with the
    coefficient axis sharded — the deep-N serving layout.

    a, b: GLOBAL u64[.., 2, n_ct, N] NTT form sharded P(..., coeff_axis).
    Returns u64[.., 2, n_ct-1, N] at the next level, same sharding —
    bit-exact vs models.pipelines.build_ckks_mul_relin_rescale.
    """
    C = mesh.shape[coeff_axis]
    _check_4step(plan.ct_tables.coeff_count, C)
    nttops = _CoeffShardedNTT(C, coeff_axis)
    q = plan.ct_limbs
    tool = plan.device_rns_tool
    tables = plan.ct_tables

    def f(a_local, b_local, key_local):
        a0, a1 = a_local[..., 0, :, :], a_local[..., 1, :, :]
        b0, b1 = b_local[..., 0, :, :], b_local[..., 1, :, :]
        mm = lambda x, y: modops.mul_mod(x, y, q.p, q.ratio0, q.ratio1)
        c0 = mm(a0, b0)
        c1 = modops.add_mod(mm(a0, b1), mm(a1, b0), q.p)
        c2 = mm(a1, b1)
        d0, d1 = switch_key(c2, key_local, plan, True, ntt=nttops)
        u = jnp.stack([
            modops.add_mod(c0, d0, q.p),
            modops.add_mod(c1, d1, q.p),
        ], axis=-3)
        return divide_and_round_q_last_ntt(u, tool, tables, ntt=nttops)

    nd = a.ndim
    spec = _coeff_spec(nd, mesh, coeff_axis, 3)
    kspec = P(None, None, None, coeff_axis)

    def build():
        return shard_map(f, mesh, in_specs=(spec, spec, kspec),
                         out_specs=spec)

    fn = _jit_cached(plan, mesh, "csp_mrr", nd, build)
    return fn(a, b, key_vector_data)


def ckks_rotate_coeff_sharded(ct, key_vector_data, elt: int, galois_tool,
                              plan: KeySwitchPlan, mesh: Mesh,
                              coeff_axis: str = "coeff"):
    """One CKKS rotation (apply_galois + key switch) with the coefficient
    axis sharded: the NTT-domain automorphism costs ONE collective-permute
    (see _galois_block_plan — it is block-local under contiguous shards),
    then the coeff-sharded switch runs its usual all_to_all four-step NTTs.

    ct: GLOBAL u64[.., 2, n_ct, N] NTT form sharded P(..., coeff_axis);
    key_vector_data: u64[nb, 2, L_key, N] sharded on N.  Returns the
    rotated ciphertext data, same shape/sharding — bit-exact vs
    Evaluator.apply_galois.  (CKKS/NTT form only: the power-basis
    automorphism is not block-local; BFV rotations use the limb-sharded
    plane.)
    """
    C = mesh.shape[coeff_axis]
    _check_4step(plan.ct_tables.coeff_count, C)
    nttops = _CoeffShardedNTT(C, coeff_axis)
    q = plan.ct_limbs
    perm, lidx = _galois_block_plan(galois_tool, elt, C)

    def f(ct_local, key_local, lidx_local):
        rot = _permute_local(ct_local, lidx_local, perm, coeff_axis)
        p0, p1 = rot[..., 0, :, :], rot[..., 1, :, :]
        d0, d1 = switch_key(p1, key_local, plan, True, ntt=nttops)
        return jnp.stack([modops.add_mod(p0, d0, q.p), d1], axis=-3)

    nd = ct.ndim
    spec = _coeff_spec(nd, mesh, coeff_axis, 3)
    kspec = P(None, None, None, coeff_axis)

    def build():
        return shard_map(f, mesh, in_specs=(spec, kspec, P(coeff_axis)),
                         out_specs=spec)

    fn = _jit_cached(plan, mesh, ("csp_rot", elt), nd, build)
    return fn(ct, key_vector_data, lidx)


def ckks_rotate_many_coeff_sharded(ct, keys_stack, elts, galois_tool,
                                   plan: KeySwitchPlan, mesh: Mesh,
                                   coeff_axis: str = "coeff"):
    """Hoisted k-rotation bundle under coefficient sharding: ONE mod-up
    digit decomposition (its NTTs being the expensive all_to_all part),
    then per step one collective-permute of the digit block + local inner
    product + the rescale's NTTs.

    ct: GLOBAL u64[.., 2, n_ct, N] NTT form sharded P(..., coeff_axis);
    keys_stack: u64[k, nb, 2, L_key, N] sharded on N.  Returns
    u64[.., k, 2, n_ct, N], same sharding on N — bit-exact vs
    Evaluator.apply_galois_many (CKKS/NTT form only).
    """
    C = mesh.shape[coeff_axis]
    _check_4step(plan.ct_tables.coeff_count, C)
    nttops = _CoeffShardedNTT(C, coeff_axis)
    q = plan.ct_limbs
    elts = tuple(int(e) for e in elts)
    if np.asarray(keys_stack).shape[0] != len(elts):
        raise ValueError("keys_stack leading axis must match elts")
    plans = [_galois_block_plan(galois_tool, e, C) for e in elts]
    lidx_all = np.stack([l for _, l in plans])    # [k, N], shard on N

    def f(ct_local, keys_local, lidx_local):
        c0 = ct_local[..., 0, :, :]
        c1 = ct_local[..., 1, :, :]
        ct_k = compute_modup_digits(c1, plan, True, ntt=nttops)  # hoisted
        outs = []
        for i in range(len(elts)):
            perm = plans[i][0]
            li = lidx_local[i]
            dig = _permute_local(ct_k, li, perm, coeff_axis)
            d0, d1 = keyswitch_inner_product(dig, keys_local[i], plan, True,
                                             ntt=nttops)
            p0 = _permute_local(c0, li, perm, coeff_axis)
            outs.append(
                jnp.stack([modops.add_mod(p0, d0, q.p), d1], axis=-3)
            )
        return jnp.stack(outs, axis=-4)           # [.., k, 2, n_ct, B]

    nd = ct.ndim
    spec = _coeff_spec(nd, mesh, coeff_axis, 3)
    out_spec = _coeff_spec(nd + 1, mesh, coeff_axis, 4)
    kspec = P(None, None, None, None, coeff_axis)

    def build():
        return shard_map(f, mesh, in_specs=(spec, kspec, P(None, coeff_axis)),
                         out_specs=out_spec)

    fn = _jit_cached(plan, mesh, ("csp_rotmany", elts), nd, build)
    return fn(ct, keys_stack, lidx_all)
