"""Explicit limb-sharded hybrid key switching (shard_map + hand-placed
collectives).

The GSPMD path (jit with limb-sharded inputs, tests/test_parallel*.py)
lets XLA choose the collectives for the key-switch contraction; its
measured profile is all-gather + all-reduce + collective-permute (PERF.md
comm table).  This module is the hand-scheduled alternative — the
communication-minimal dataflow for a multi-device mesh:

- each device owns `n_ct / C` NORMAL limb rows of the ciphertext;
- mod-up needs every device to read all limbs of the power-basis target
  once, so the schedule is exactly ONE `all_gather` of the (per-limb
  inverse-NTT'd) target — `n_ct * N * 8` bytes per device per switch;
- each device then computes the digit rows, inner product, and special-
  prime rescale for ITS OWN rows entirely locally; the `nsp` special rows
  (1-3 rows) are computed redundantly on every device instead of being
  exchanged — redundant compute is ~nsp/n_ct of a switch, far cheaper
  than a second interconnect hop.

`ckks_mul_relin_rescale_limb_sharded` composes the full serving hot step
on the same schedule: the ciphertext convolution is limb-local, the relin
switch costs the one target gather, and the rescale adds a single tiny
all-reduce broadcasting the rounded q_last limb (one row per component) —
total traffic per step: (n_ct + 2) polynomial rows.

Every per-device constant (table rows, Barrett ratios, bundle matrix
rows, key rows) enters shard_map as a SHARDED OPERAND, so each device's
program sees only its static local slice — no device-index dynamic
slicing — and is device_put once per (plan, mesh, keys).

Bit-exact with the in-core ops (same math, same lazy ranges, row-sliced
constants), except the pipeline's dropped q_last row, which is returned
as a zero pad (the next level re-shards).

No reference analogue (single-process library; SURVEY §2.4).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import modops
from ..ops.keyswitch import KeySwitchPlan
from ..ops.ntt import (NTTTables, ntt_forward, ntt_forward_lazy, ntt_inverse,
                       ntt_inverse_lazy)
from .ntt_sp import shard_map

__all__ = ["switch_key_limb_sharded", "ckks_mul_relin_rescale_limb_sharded",
           "rotate_many_limb_sharded"]

_TAB_FIELDS = (
    "roots", "root_powers", "scaled_root_powers", "inv_root_powers",
    "scaled_inv_root_powers", "inv_degree_modulo", "scaled_inv_degree",
    "reduce_precomp", "modulus",
)


def _tables_rows(t: NTTTables, start: int, stop: int) -> dict:
    return {f: np.asarray(getattr(t, f))[start:stop] for f in _TAB_FIELDS}


def _tables_from(fields: dict, cc_power: int, cc: int) -> NTTTables:
    return NTTTables(coeff_count_power=cc_power, coeff_count=cc, moduli=[],
                     **fields)


def _accum_terms_128(pairs, p, r0, r1):
    """Shared 128-bit digit-plane accumulator (ops.modops)."""
    return modops.accumulate_mulmod_128(pairs, p, r0, r1)


def _modup_rows(power_target, tgt_ntt_rows, plan, rows, tables):
    """Digit rows [.., nb, rows_count, N] for the ext rows described by
    the `rows` constant dict (mat/diag/p/r0/r1 already row-sliced)."""
    nb, s_max = plan.bundle_sel.shape
    N = power_target.shape[-1]

    x_sel = jnp.take(power_target, plan.bundle_sel.ravel(), axis=-2)
    x_sel = x_sel.reshape(power_target.shape[:-2] + (nb, s_max, N))
    temp = modops.mul_mod(
        x_sel, plan.bundle_inv, plan.bundle_p, plan.bundle_r0, plan.bundle_r1
    )
    pairs = [
        (temp[..., :, None, i, :], rows["mat"][:, :, i, None])
        for i in range(s_max)
    ]
    lifted = _accum_terms_128(pairs, rows["p"], rows["r0"], rows["r1"])
    if plan.lazy_digits:
        lifted_ntt = ntt_forward_lazy(lifted, tables)
    else:
        lifted_ntt = ntt_forward(lifted, tables)
    if tgt_ntt_rows is None:
        return lifted_ntt
    return jnp.where(rows["diag"], tgt_ntt_rows[..., None, :, :], lifted_ntt)


def _plan_consts(plan: KeySwitchPlan, mesh: Mesh, key_vector_data):
    """Per-device constants + key rows, sharded over 'limb', device_put
    ONCE per (plan, mesh, keys) and cached — the serving hot path must not
    re-transfer megabytes of tables/keys per switch."""
    n_ct, nsp = plan.n_ct_rns, plan.n_sp_rns
    n_ct_all = plan.n_ct_all_rns

    cache = plan.__dict__.setdefault("_sp_norm_cache", {})
    nkey = (
        tuple(mesh.devices.flat),
        tuple(sorted(mesh.shape.items())),
        mesh.axis_names,
        id(key_vector_data),
    )
    hit = cache.get(nkey)
    if hit is not None and hit[0] is key_vector_data:
        return hit[1], hit[2]
    if len(cache) >= 8:  # bound pinned key memory; oldest plan evicted
        cache.pop(next(iter(cache)))

    norm_tab = _tables_rows(plan.ext_tables, 0, n_ct)
    key_host = np.asarray(key_vector_data)
    # key sets may be stacked ([nb, 2, L, N] for one switch key, or
    # [k, nb, 2, L, N] for a hoisted rotation bundle) — the limb axis is
    # always at -2, so slice/shard with an ellipsis-shaped spec
    key_lead = key_host.ndim - 2
    # rescale constants come from the level's RNSTool precompute
    # (utils/rns.py, rns.cpp:719-729 parity) — single source of truth with
    # the in-core divide_and_round_q_last_ntt; padded to n_ct rows (the
    # dropped q_last row's entry is a dummy, its output is zeroed)
    inv_q = np.ones((n_ct, 1), dtype=np.uint64)
    inv_q[: n_ct - 1] = np.asarray(
        plan.device_rns_tool.inv_q_last_mod_q
    ).reshape(n_ct - 1, 1)

    norm = {
        "tab": norm_tab,
        "mat": np.ascontiguousarray(plan.bundle_mat[:, :n_ct, :]),
        "diag": np.ascontiguousarray(plan.bundle_diag[:, :n_ct]),
        "p": plan.ct_limbs.p, "r0": plan.ct_limbs.ratio0,
        "r1": plan.ct_limbs.ratio1,
        "neg": plan.neg_hat_pj_qi,             # [n_ct, nsp]
        "invP": plan.inv_P_qi,                 # [n_ct, 1]
        "key": key_host[..., :n_ct, :],
        "key_sp": key_host[..., n_ct_all : n_ct_all + nsp, :],
        "inv_q_last": inv_q,                   # [n_ct, 1] (last row dummy)
    }
    norm_specs = {
        "tab": {f: P("limb", *([None] * (np.asarray(v).ndim - 1)))
                for f, v in norm_tab.items()},
        "mat": P(None, "limb", None),
        "diag": P(None, "limb", None),
        "p": P("limb", None), "r0": P("limb", None), "r1": P("limb", None),
        "neg": P("limb", None),
        "invP": P("limb", None),
        "key": P(*([None] * key_lead), "limb", None),
        "key_sp": P(),
        "inv_q_last": P("limb", None),
    }
    norm = jax.device_put(
        norm,
        jax.tree.map(lambda s: NamedSharding(mesh, s), norm_specs,
                     is_leaf=lambda x: isinstance(x, P)),
    )
    cache[nkey] = (key_vector_data, norm, norm_specs)
    return norm, norm_specs


def _sp_consts(plan: KeySwitchPlan):
    """Replicated special-row constants (tiny; computed redundantly)."""
    n_ct = plan.n_ct_rns
    cc_power = plan.ct_tables.coeff_count_power
    cc = plan.ct_tables.coeff_count
    sp_rows = {
        "mat": plan.bundle_mat[:, n_ct:, :],
        "p": plan.sp_limbs.p, "r0": plan.sp_limbs.ratio0,
        "r1": plan.sp_limbs.ratio1,
    }
    sp_tables = _tables_from(_tables_rows(plan.ext_tables, n_ct, plan.n_ext),
                             cc_power, cc)
    return sp_rows, sp_tables


def _hoist_digits(tgt_local, c, tab_own, plan, sp_rows, sp_tables,
                  is_ntt_form: bool):
    """Mod-up decomposition of the device's rows: one all_gather of the
    power-basis target, then local digit rows (own + redundant special).
    Returns (dig_own, dig_sp) — the hoistable half of a key switch."""
    lax_axis = tgt_local.ndim - 2
    if is_ntt_form:
        pt_local = ntt_inverse_lazy(tgt_local, tab_own)
        diag_src = tgt_local
    else:
        pt_local = tgt_local
        if plan.lazy_digits:
            diag_src = ntt_forward_lazy(tgt_local, tab_own)
        else:
            diag_src = ntt_forward(tgt_local, tab_own)
    power_target = jax.lax.all_gather(
        pt_local, "limb", axis=lax_axis, tiled=True
    )  # the ONE collective of the switch: [.., n_ct, N]

    dig_own = _modup_rows(power_target, diag_src, plan, c, tab_own)
    dig_sp = _modup_rows(power_target, None, plan, sp_rows, sp_tables)
    return dig_own, dig_sp


def _sp_fold(acc_own, acc_sp, c, tab_own, plan, sp_rows, sp_tables,
             is_ntt_form: bool):
    """Row-sliced special-prime rescale (ops.keyswitch.rescale_special):
    fold the replicated special-row accumulator into the device's own
    rows and divide by P.  Bit-exact with the in-core pass per row."""
    nsp = plan.n_sp_rns
    sp_power = ntt_inverse_lazy(acc_sp, sp_tables)
    scaled = modops.mul_mod(
        sp_power, plan.inv_hat_pj_pj,
        sp_rows["p"], sp_rows["r0"], sp_rows["r1"],
    )
    temp = _accum_terms_128(
        [(scaled[..., None, j, :], c["neg"][:, j, None])
         for j in range(nsp)],
        c["p"], c["r0"], c["r1"],
    )
    if is_ntt_form:
        temp = ntt_forward(temp, tab_own)
        s = modops.add_mod(acc_own, temp, c["p"])
    else:
        normal_power = ntt_inverse(acc_own, tab_own)
        s = modops.add_mod(normal_power, temp, c["p"])
    return modops.mul_mod(s, c["invP"], c["p"], c["r0"], c["r1"])


def _inner_rescale(dig_own, dig_sp, key_own, key_sp, c, tab_own, plan,
                   sp_rows, sp_tables, is_ntt_form: bool):
    """Key inner product + special-prime rescale on the device's rows
    (all local; sp rows computed redundantly).  key_own/key_sp:
    [nb, 2, rows, N] for one key set.  Returns (d0_local, d1_local)."""
    nb = plan.bundle_sel.shape[0]

    outs = []
    for l in range(2):
        acc_own = _accum_terms_128(
            [(dig_own[..., b, :, :], key_own[b, l]) for b in range(nb)],
            c["p"], c["r0"], c["r1"],
        )
        acc_sp = _accum_terms_128(
            [(dig_sp[..., b, :, :], key_sp[b, l]) for b in range(nb)],
            sp_rows["p"], sp_rows["r0"], sp_rows["r1"],
        )
        outs.append(_sp_fold(acc_own, acc_sp, c, tab_own, plan, sp_rows,
                             sp_tables, is_ntt_form))
    return outs[0], outs[1]


def _switch_local(tgt_local, c, tab_own, plan, sp_rows, sp_tables,
                  is_ntt_form: bool):
    """The per-device switch body: one all_gather, everything else local.
    Returns (d0_local, d1_local) for this device's rows."""
    dig_own, dig_sp = _hoist_digits(tgt_local, c, tab_own, plan, sp_rows,
                                    sp_tables, is_ntt_form)
    return _inner_rescale(dig_own, dig_sp, c["key"], c["key_sp"], c, tab_own,
                          plan, sp_rows, sp_tables, is_ntt_form)


def _data_spec(nd: int, mesh: Mesh, n_trailing: int) -> P:
    """Partition spec for [batch..., (size,) limb, N] data: 'limb' on the
    limb axis and, when the mesh has a 'dp' axis and the data has batch
    dims, 'dp' on the leading batch axis — the recommended (dp, limb)
    production layout (PERF.md comm table, ratio 0.52) runs the SAME
    one-gather schedule: the switch body is batch-polymorphic and its
    collectives name only the 'limb' axis, so dp shards move zero bytes."""
    n_batch = nd - n_trailing
    lead = [None] * n_batch
    if "dp" in mesh.axis_names and n_batch > 0:
        lead[0] = "dp"
    trail = [None] * (n_trailing - 2) + ["limb", None]
    return P(*(lead + trail))


def _jit_cached(plan, mesh, tag, nd, build):
    cache = plan.__dict__.setdefault("_sp_jit_cache", {})
    ckey = (tuple(mesh.devices.flat), tuple(sorted(mesh.shape.items())),
            tag, nd)
    fn = cache.get(ckey)
    if fn is None:
        fn = jax.jit(build())
        cache[ckey] = fn
    return fn


def switch_key_limb_sharded(target, key_vector_data, plan: KeySwitchPlan,
                            mesh: Mesh, is_ntt_form: bool = True):
    """Hybrid key switch over a limb-sharded mesh.

    target: GLOBAL u64[n_ct, N] (or [batch, n_ct, N]) polynomial in the
    ciphertext domain (NTT iff is_ntt_form — CKKS serving vs BFV power
    basis), sharded P(..., 'limb', None); key_vector_data:
    u64[nb, 2, L_key, N] (replicated or host).  Returns (d0, d1) with the
    target's sharding, in the ciphertext domain.  Both dataflows keep the
    single-gather schedule.  Requires n_ct % mesh.shape['limb'] == 0.
    """
    C = mesh.shape["limb"]
    if plan.n_ct_rns % C != 0:
        raise ValueError(f"n_ct={plan.n_ct_rns} not divisible by limb={C}")
    cc_power = plan.ct_tables.coeff_count_power
    cc = plan.ct_tables.coeff_count
    norm, norm_specs = _plan_consts(plan, mesh, key_vector_data)
    sp_rows, sp_tables = _sp_consts(plan)

    def f(tgt_local, c):
        tab_own = _tables_from(c["tab"], cc_power, cc)
        return _switch_local(tgt_local, c, tab_own, plan, sp_rows, sp_tables,
                             is_ntt_form)

    nd = target.ndim
    spec = _data_spec(nd, mesh, 2)

    def build():
        # jit-wrapped: an EAGER shard_map call dispatches primitive-by-
        # primitive across the device set (~200 s for this graph on the
        # virtual mesh); one compiled program runs it in microseconds.
        return shard_map(f, mesh, in_specs=(spec, norm_specs),
                         out_specs=(spec, spec))

    fn = _jit_cached(plan, mesh, ("switch", is_ntt_form), nd, build)
    return fn(target, norm)


def rotate_many_limb_sharded(ct, keys_stack, elts, galois_tool,
                             plan: KeySwitchPlan, mesh: Mesh,
                             is_ntt_form: bool = True):
    """Hoisted k-rotation bundle on the one-gather schedule.

    The in-core hoisting (Evaluator.apply_galois_many) computes the mod-up
    digit decomposition of c1 ONCE and reuses it for every Galois element;
    here the same hoist shares the schedule's ONE all_gather across all k
    rotations — k switches for the collective cost of one (the per-step Galois
    permutation acts along the unsharded N axis, so it is device-local).

    ct: GLOBAL u64[.., 2, n_ct, N] ciphertext data (NTT iff is_ntt_form),
    sharded P(..., None, 'limb', None); keys_stack: u64[k, nb, 2, L_key, N]
    stacked Galois-key tensors, one per element (KSwitchKeys.stacked order
    matching `elts`); elts: static Galois elements; galois_tool: the
    level's GaloisTool (permutation tables are baked into the program).

    Returns u64[.., k, 2, n_ct, N] — the k rotated ciphertexts, sharded on
    the limb axis like the input.  Rows bit-exact vs apply_galois_many.
    """
    C = mesh.shape["limb"]
    if plan.n_ct_rns % C != 0:
        raise ValueError(f"n_ct={plan.n_ct_rns} not divisible by limb={C}")
    elts = tuple(int(e) for e in elts)
    if np.asarray(keys_stack).shape[0] != len(elts):
        raise ValueError("keys_stack leading axis must match elts")
    cc_power = plan.ct_tables.coeff_count_power
    cc = plan.ct_tables.coeff_count
    norm, norm_specs = _plan_consts(plan, mesh, keys_stack)
    sp_rows, sp_tables = _sp_consts(plan)
    # permutation tables: NTT-domain take-index per element, plus the
    # power-basis (gather, sign) pair for the BFV c0 path
    ntt_perms = [galois_tool._ntt_table(e) for e in elts]
    coeff_perms = [galois_tool._coeff_table(e) for e in elts]

    def f(ct_local, c):
        tab_own = _tables_from(c["tab"], cc_power, cc)
        c0 = ct_local[..., 0, :, :]
        c1 = ct_local[..., 1, :, :]
        dig_own, dig_sp = _hoist_digits(c1, c, tab_own, plan, sp_rows,
                                        sp_tables, is_ntt_form)
        outs = []
        for i in range(len(elts)):
            perm = ntt_perms[i]
            dgo = jnp.take(dig_own, perm, axis=-1)
            dgs = jnp.take(dig_sp, perm, axis=-1)
            d0, d1 = _inner_rescale(dgo, dgs, c["key"][i], c["key_sp"][i],
                                    c, tab_own, plan, sp_rows, sp_tables,
                                    is_ntt_form)
            if is_ntt_form:
                p0 = jnp.take(c0, perm, axis=-1)
            else:
                src, negm = coeff_perms[i]
                g = jnp.take(c0, src, axis=-1)
                p0 = jnp.where(negm, modops.neg_mod(g, c["p"]), g)
            nc0 = modops.add_mod(p0, d0, c["p"])
            outs.append(jnp.stack([nc0, d1], axis=-3))
        return jnp.stack(outs, axis=-4)   # [.., k, 2, rpn, N]

    nd = ct.ndim
    in_spec = _data_spec(nd, mesh, 3)
    # output [batch..., k, 2, rpn, N]: dp stays on the input's leading
    # BATCH axis only — never on the new k (rotation-step) axis
    out_lead = [None] * (nd - 2)
    if "dp" in mesh.axis_names and nd > 3:
        out_lead[0] = "dp"
    out_spec = P(*(out_lead + [None, "limb", None]))

    def build():
        return shard_map(f, mesh, in_specs=(in_spec, norm_specs),
                         out_specs=out_spec)

    fn = _jit_cached(plan, mesh, ("rotmany", is_ntt_form, elts), nd, build)
    return fn(ct, norm)


def ckks_mul_relin_rescale_limb_sharded(a, b, key_vector_data,
                                        plan: KeySwitchPlan, mesh: Mesh):
    """The full CKKS serving hot step (multiply + relinearize + rescale)
    on the explicit limb-sharded schedule.

    a, b: GLOBAL u64[.., 2, n_ct, N] NTT-form ciphertext data sharded
    P(..., None, 'limb', None).  Returns u64[.., 2, n_ct, N] at the NEXT
    level in NTT form with the same sharding; the dropped q_last row
    (global row n_ct - 1) is returned ZEROED as padding — slice
    [..., :n_ct-1, :] for the next level's tensor (rows [:n_ct-1] are
    bit-exact with pipelines.build_ckks_mul_relin_rescale's output).

    Traffic per device per step: one all_gather of the c2 target (n_ct rows)
    + one 2-row all-reduce broadcast of the rounded q_last limb.
    """
    C = mesh.shape["limb"]
    n_ct = plan.n_ct_rns
    if n_ct % C != 0:
        raise ValueError(f"n_ct={n_ct} not divisible by limb={C}")
    rpn = n_ct // C
    cc_power = plan.ct_tables.coeff_count_power
    cc = plan.ct_tables.coeff_count
    norm, norm_specs = _plan_consts(plan, mesh, key_vector_data)
    sp_rows, sp_tables = _sp_consts(plan)
    q_last = np.uint64(plan.ct_limbs.p[n_ct - 1, 0])
    q_last_r1 = np.uint64(plan.ct_limbs.ratio1[n_ct - 1, 0])
    half = np.uint64(int(q_last) >> 1)

    def f(a_local, b_local, c):
        tab_own = _tables_from(c["tab"], cc_power, cc)
        d = jax.lax.axis_index("limb")

        # (1) convolution: limb-local dyadic products on own rows
        a0, a1 = a_local[..., 0, :, :], a_local[..., 1, :, :]
        b0, b1 = b_local[..., 0, :, :], b_local[..., 1, :, :]
        mm = lambda x, y: modops.mul_mod(x, y, c["p"], c["r0"], c["r1"])
        c0 = mm(a0, b0)
        c1 = modops.add_mod(mm(a0, b1), mm(a1, b0), c["p"])
        c2 = mm(a1, b1)

        # (2) relinearize: explicit switch on c2 (the one gather)
        d0, d1 = _switch_local(c2, c, tab_own, plan, sp_rows, sp_tables, True)
        u0 = modops.add_mod(c0, d0, c["p"])
        u1 = modops.add_mod(c1, d1, c["p"])
        u = jnp.stack([u0, u1], axis=-3)          # [.., 2, rpn, N]

        # (3) rescale by q_last: the owner (device C-1) inverse-NTTs its
        # last row; a masked psum broadcasts that ONE row to everyone
        # (a single tiny all-reduce — ppermute disallows one-to-many)
        last_tab = _tables_from(
            {f_: c["tab"][f_][rpn - 1 : rpn] for f_ in _TAB_FIELDS},
            cc_power, cc,
        )
        cand = ntt_inverse(u[..., rpn - 1 : rpn, :], last_tab)  # [..,2,1,N]
        last = jax.lax.psum(
            jnp.where(d == C - 1, cand, jnp.uint64(0)), "limb"
        )
        last = modops.barrett_reduce_64(last + half, q_last, q_last_r1)

        last_mod_qi = modops.barrett_reduce_64(last, c["p"], c["r1"])
        # half mod q_i computed in-trace, exactly like the in-core
        # divide_and_round_q_last_ntt (rnsops.py) — no duplicated precompute
        half_mod = modops.barrett_reduce_64(half, c["p"], c["r1"])
        temp = modops.sub_mod(last_mod_qi, half_mod, c["p"])
        temp = ntt_forward(temp, tab_own)
        diff = modops.sub_mod(u, temp, c["p"])
        out = modops.mul_mod(diff, c["inv_q_last"], c["p"], c["r0"], c["r1"])

        # zero the dropped global-last row (device C-1's local row rpn-1)
        row_ids = jnp.arange(rpn).reshape(rpn, 1)
        pad = jnp.logical_and(row_ids == rpn - 1, d == C - 1)
        return jnp.where(pad, jnp.uint64(0), out)

    nd = a.ndim
    spec = _data_spec(nd, mesh, 3)

    def build():
        return shard_map(f, mesh, in_specs=(spec, spec, norm_specs),
                         out_specs=spec)

    fn = _jit_cached(plan, mesh, "mrr", nd, build)
    return fn(a, b, norm)
