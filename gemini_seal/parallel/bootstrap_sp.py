"""Limb-sharded bootstrap linear stages: the C2S/S2C BSGS matvec on the
one-gather key-switch schedule.

The bootstrap's CoeffToSlot / SlotToCoeff groups are hoisted matvecs
(models.pipelines.build_ckks_matvec): ONE mod-up digit decomposition
feeds every rotation of the group, each rotated digit set is inner-
producted with its Galois key, multiplied by the group's extended-base
diagonal plaintext, and the RAW accumulators are special-prime mod-downed
ONCE.  That contraction is exactly the pattern keyswitch_sp already
shards — each device owns n_ct / C limb rows, the hoist costs ONE
`all_gather` of the inverse-NTT'd c1 (n_ct * N * 8 bytes per device per
GROUP, not per rotation), and every rotation/diagonal product after it is
row-local (Galois permutations act along the unsharded N axis; the
special rows are computed redundantly).

Interconnect traffic per refresh (split mode, Gn groups per transform):
the C2S chain and the S2C chain each issue Gn one-gather matvecs and the two EvalMod halves
ride dp/limb-sharded square chains — 2 * Gn + 1 (conjugation) + 2
(s2c_a/s2c_b share the first level's two matvecs) gathers of n_ct rows
total; see PERF.md's comm table for the byte model.

The BATCH story needs no schedule at all: the composed bootstrap `run`
(models.bootstrap, per-stage jitted programs) is batch-polymorphic, so a
[batch, 2, 1, N] input sharded P('dp', ...) refreshes dp ways with ZERO
collectives (tests/test_bootstrap_sp.py pins the HLO).

Bit-exact with build_ckks_matvec(fuse_moddown=True) — same 128-bit
accumulation (order-free: exact until the single Barrett reduction),
same special-prime fold, row-sliced constants.

No reference analogue (the fork has neither bootstrap nor multi-device
execution; SURVEY §2.4 / §5).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import jax.numpy as jnp

from ..modulus import Modulus
from ..ops import modops
from ..ops.keyswitch import KeySwitchPlan
from .keyswitch_sp import (
    _accum_terms_128,
    _data_spec,
    _hoist_digits,
    _plan_consts,
    _sp_consts,
    _sp_fold,
    _tables_from,
)
from .ntt_sp import shard_map

__all__ = ["build_ckks_matvec_limb_sharded"]


def build_ckks_matvec_limb_sharded(context, diagonals, scale, encoder,
                                   mesh: Mesh, parms_id=None):
    """Limb-sharded hoisted matvec: the sharded twin of models.pipelines.
    build_ckks_matvec (fuse_moddown path) for a bootstrap C2S/S2C group.

    diagonals: {step d: slot values} as in the in-core builder.
    Returns fn(ct, keys_stack) -> u64[..., 2, n_ct, N] at the SAME level
    with scale*scale; ct sharded P(..., None, 'limb', None) over `mesh`,
    keys_stack u64[R, nb, 2, L_key, N] (host or replicated) ordered by
    sorted nonzero steps.  Requires n_ct % mesh.shape['limb'] == 0.
    """
    if parms_id is None:
        parms_id = context.first_parms_id
    cd = context.get_context_data(parms_id)
    tool = cd.galois_tool
    plan = KeySwitchPlan(context, parms_id)
    C = mesh.shape["limb"]
    n_ct = plan.n_ct_rns
    if n_ct % C != 0:
        raise ValueError(f"n_ct={n_ct} not divisible by limb={C}")
    cc_power = plan.ct_tables.coeff_count_power
    cc = plan.ct_tables.coeff_count

    steps = sorted(diagonals.keys())
    rot_steps = [s for s in steps if s != 0]
    elts = tuple(tool.get_elt_from_step(s) for s in rot_steps)
    R = len(rot_steps)
    if R == 0:
        raise ValueError("need at least one nonzero diagonal to shard")
    ntt_perms = [tool._ntt_table(e) for e in elts]

    ext_mods = [Modulus(p) for p in plan.ext_moduli]
    pte = np.stack([
        encoder.encode_at_base(list(diagonals[s]), scale, parms_id,
                               ext_mods, plan.ext_tables)
        for s in rot_steps
    ])                                             # [R, n_ext, N]
    ptc = np.stack([
        np.asarray(encoder.encode(list(diagonals[s]), scale, parms_id).data)
        for s in rot_steps
    ])                                             # [R, n_ct, N]
    dg_host = {
        "ptc": ptc,
        "pte_own": np.ascontiguousarray(pte[:, :n_ct, :]),
        "pte_sp": np.ascontiguousarray(pte[:, n_ct:, :]),
    }
    dg_specs = {
        "ptc": P(None, "limb", None),
        "pte_own": P(None, "limb", None),
        "pte_sp": P(),
    }
    if 0 in diagonals:
        dg_host["pt0"] = np.asarray(
            encoder.encode(list(diagonals[0]), scale, parms_id).data)
        dg_specs["pt0"] = P("limb", None)
    dg = jax.device_put(
        dg_host,
        jax.tree.map(lambda s: NamedSharding(mesh, s), dg_specs,
                     is_leaf=lambda x: isinstance(x, P)),
    )
    sp_rows, sp_tables = _sp_consts(plan)
    nb = plan.bundle_sel.shape[0]

    def f(ct_local, c, d):
        tab_own = _tables_from(c["tab"], cc_power, cc)
        c0 = ct_local[..., 0, :, :]
        c1 = ct_local[..., 1, :, :]
        dig_own, dig_sp = _hoist_digits(c1, c, tab_own, plan, sp_rows,
                                        sp_tables, True)
        a_own, a_sp = [[], []], [[], []]
        for i in range(R):
            perm = ntt_perms[i]
            dgo = jnp.take(dig_own, perm, axis=-1)
            dgs = jnp.take(dig_sp, perm, axis=-1)
            for l in range(2):
                a_own[l].append(_accum_terms_128(
                    [(dgo[..., b, :, :], c["key"][i][b, l])
                     for b in range(nb)],
                    c["p"], c["r0"], c["r1"]))
                a_sp[l].append(_accum_terms_128(
                    [(dgs[..., b, :, :], c["key_sp"][i][b, l])
                     for b in range(nb)],
                    sp_rows["p"], sp_rows["r0"], sp_rows["r1"]))
        raw_own = [_accum_terms_128(
            [(a_own[l][i], d["pte_own"][i]) for i in range(R)],
            c["p"], c["r0"], c["r1"]) for l in range(2)]
        raw_sp = [_accum_terms_128(
            [(a_sp[l][i], d["pte_sp"][i]) for i in range(R)],
            sp_rows["p"], sp_rows["r0"], sp_rows["r1"]) for l in range(2)]
        d0 = _sp_fold(raw_own[0], raw_sp[0], c, tab_own, plan, sp_rows,
                      sp_tables, True)
        d1 = _sp_fold(raw_own[1], raw_sp[1], c, tab_own, plan, sp_rows,
                      sp_tables, True)
        ct_part = _accum_terms_128(
            [(jnp.take(c0, ntt_perms[i], axis=-1), d["ptc"][i])
             for i in range(R)],
            c["p"], c["r0"], c["r1"])
        nc0 = modops.add_mod(ct_part, d0, c["p"])
        nc1 = d1
        if "pt0" in d:
            nc0 = modops.add_mod(
                nc0, modops.mul_mod(c0, d["pt0"], c["p"], c["r0"], c["r1"]),
                c["p"])
            nc1 = modops.add_mod(
                nc1, modops.mul_mod(c1, d["pt0"], c["p"], c["r0"], c["r1"]),
                c["p"])
        return jnp.stack([nc0, nc1], axis=-3)

    jits = {}

    def _jf(ct, keys_stack):
        norm, norm_specs = _plan_consts(plan, mesh, keys_stack)
        nd = ct.ndim
        jf = jits.get(nd)
        if jf is None:
            spec = _data_spec(nd, mesh, 3)
            jf = jax.jit(shard_map(
                f, mesh, in_specs=(spec, norm_specs, dg_specs),
                out_specs=spec))
            jits[nd] = jf
        return jf, norm

    def fn(ct, keys_stack):
        jf, norm = _jf(ct, keys_stack)
        return jf(ct, norm, dg)

    def compiled_text(ct, keys_stack):
        """Compiled-HLO text for the collective-profile guards."""
        jf, norm = _jf(ct, keys_stack)
        return jf.lower(ct, norm, dg).compile().as_text()

    fn.rot_steps = rot_steps
    fn.compiled_text = compiled_text
    return fn
