"""Explicit limb-sharded BFV BEHZ multiply (+relinearize).

The BEHZ base-extension contraction (reference: rns.cpp:452-523 FastBConv,
925-1068 sm_mrq/fastbconv_m_tilde) is SURVEY §2.4's canonical sharded
matmul.  This module hand-schedules benchmark config 1/3's hot step on the
same communication-minimal pattern as parallel/keyswitch_sp.py:

- each device owns n_ct/C rows of the q base AND n_B/C rows of the B base
  (n_B == n_ct, so both split evenly — no padding);
- the two SINGLE extension rows (m_tilde for the Montgomery tag, m_sk for
  the Shenoy-Kumaresan correction) are computed REDUNDANTLY on every
  device from the gathered sources — the exact pattern keyswitch_sp uses
  for the special primes: ~1/n_B extra compute, zero extra hops, and
  no gather carries a padded or single-row tensor;
- every base conversion is ONE tiled all_gather of the pre-scaled source
  rows followed by a device-local 128-bit-exact contraction onto the
  device's own output rows;
- the whole multiply+relinearize runs in FIVE all-gathers: two operand
  extends (q -> B u {m_tilde, m_sk}), one fast_floor lift (q -> Bsk), one
  Shenoy-Kumaresan return (B -> q), one relin key-switch target — vs
  the GSPMD profile's all-reduce + permute mix (PERF.md comm table).

Bit-exact with models.pipelines.build_bfv_mul_relin: identical lazy NTT
ranges, identical accumulate_mulmod_128 contraction order (ascending
global input row), row-sliced copies of the same DeviceRNSTool constants.

Supports the (dp, limb) production mesh: batch axes enter dp-sharded and
all collectives name only 'limb' (see keyswitch_sp._data_spec).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import modops
from ..ops.keyswitch import KeySwitchPlan
from ..ops.ntt import ntt_forward_lazy, ntt_inverse
from .keyswitch_sp import (_data_spec, _jit_cached, _plan_consts, _sp_consts,
                           _switch_local, _tables_from, _TAB_FIELDS)
from .ntt_sp import shard_map

__all__ = ["bfv_mul_relin_limb_sharded"]


def _acc128(pairs, p, r0, r1):
    return modops.accumulate_mulmod_128(pairs, p, r0, r1)


def _behz_consts(tool, plan: KeySwitchPlan, mesh: Mesh):
    """Row-sharded BEHZ constants, device_put once per (tool, mesh)."""
    cache = tool.__dict__.setdefault("_behz_sp_cache", {})
    nkey = (tuple(mesh.devices.flat), tuple(sorted(mesh.shape.items())),
            mesh.axis_names)
    hit = cache.get(nkey)
    if hit is not None:
        return hit

    n_ct = tool.base_q_size
    n_b = tool.base_B_size
    bsk = tool.Bsk_limbs
    btab = {f: np.asarray(getattr(tool.base_Bsk_ntt_tables, f))
            for f in _TAB_FIELDS}

    # --- q-sharded rows -------------------------------------------------
    qtab = {f: np.asarray(getattr(plan.ct_tables, f)) for f in _TAB_FIELDS}
    cq = {
        "tab": qtab,
        "p": tool.q_limbs.p, "r0": tool.q_limbs.ratio0,
        "r1": tool.q_limbs.ratio1,
        "invp": tool.q_to_Bsk.inv_punctured,          # [n_ct, 1]
        "bq_mat": np.ascontiguousarray(tool.B_to_q.matrix),  # [n_ct, n_B]
        "prod_B": tool.prod_B_mod_q,                   # [n_ct, 1]
    }
    cq_specs = {
        "tab": {f: P("limb", *([None] * (v.ndim - 1)))
                for f, v in qtab.items()},
        "p": P("limb", None), "r0": P("limb", None), "r1": P("limb", None),
        "invp": P("limb", None),
        "bq_mat": P("limb", None),
        "prod_B": P("limb", None),
    }

    # --- B-sharded rows (n_B == n_ct: splits evenly, no padding) --------
    def bsk_rows(sl):
        return {
            "tab": {f: np.ascontiguousarray(v[sl]) for f, v in btab.items()},
            "p": np.ascontiguousarray(bsk.p[sl]),
            "r0": np.ascontiguousarray(bsk.ratio0[sl]),
            "r1": np.ascontiguousarray(bsk.ratio1[sl]),
            "qbsk_mat": np.ascontiguousarray(tool.q_to_Bsk.matrix[sl]),
            "prod_q": np.ascontiguousarray(tool.prod_q_mod_Bsk[sl]),
            "inv_mt": np.ascontiguousarray(tool.inv_m_tilde_mod_Bsk[sl]),
            "inv_prod_q": np.ascontiguousarray(tool.inv_prod_q_mod_Bsk[sl]),
        }

    ce = bsk_rows(slice(0, n_b))
    ce["invp_B"] = np.ascontiguousarray(tool.B_to_q.inv_punctured[:n_b])
    ce_specs = {
        "tab": {f: P("limb", *([None] * (np.asarray(v).ndim - 1)))
                for f, v in ce["tab"].items()},
        "p": P("limb", None), "r0": P("limb", None), "r1": P("limb", None),
        "qbsk_mat": P("limb", None),
        "prod_q": P("limb", None),
        "inv_mt": P("limb", None),
        "inv_prod_q": P("limb", None),
        "invp_B": P("limb", None),
    }

    # --- replicated single-row constants --------------------------------
    mt_ob = tool.q_to_m_tilde.obase
    cr = {
        "qmt_mat": np.asarray(tool.q_to_m_tilde.matrix),   # [1, n_ct]
        "bmsk_mat": np.asarray(tool.B_to_m_sk.matrix),      # [1, n_B]
        "mt_p": mt_ob.p, "mt_r0": mt_ob.ratio0, "mt_r1": mt_ob.ratio1,
        "msk": bsk_rows(slice(n_b, n_b + 1)),  # the m_sk row, replicated
    }
    cr_specs = {
        "qmt_mat": P(), "bmsk_mat": P(),
        "mt_p": P(), "mt_r0": P(), "mt_r1": P(),
        "msk": {
            "tab": {f: P() for f in cr["msk"]["tab"]},
            "p": P(), "r0": P(), "r1": P(),
            "qbsk_mat": P(), "prod_q": P(), "inv_mt": P(), "inv_prod_q": P(),
        },
    }

    consts = {"q": cq, "e": ce, "r": cr}
    specs = {"q": cq_specs, "e": ce_specs, "r": cr_specs}
    consts = jax.device_put(
        consts,
        jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                     is_leaf=lambda x: isinstance(x, P)),
    )
    meta = {
        "n_ct": n_ct, "n_b": n_b,
        "m_tilde": np.uint64(tool.m_tilde.value),
        "inv_q_mt": np.uint64(tool.inv_prod_q_mod_m_tilde),
        "m_sk": np.uint64(tool.m_sk.value),
        "msk_r0": np.uint64(tool.m_sk.const_ratio[0]),
        "msk_r1": np.uint64(tool.m_sk.const_ratio[1]),
        "inv_B_msk": np.uint64(tool.inv_prod_B_mod_m_sk),
        "t": np.uint64(tool.t.value),
    }
    cache[nkey] = (consts, specs, meta)
    return consts, specs, meta


def bfv_mul_relin_limb_sharded(a, b, key_vector_data, context, mesh: Mesh,
                               parms_id=None):
    """BFV BEHZ multiply + relinearize over a limb-sharded mesh.

    a, b: GLOBAL u64[.., 2, n_ct, N] power-basis ciphertext data sharded
    P(..., None, 'limb', None) (plus 'dp' on the leading batch axis when
    the mesh has one).  key_vector_data: u64[nb, 2, L_key, N].  Returns
    u64[.., 2, n_ct, N] with the inputs' sharding — bit-exact with
    jit(build_bfv_mul_relin(context))(a, b, key).
    """
    if parms_id is None:
        parms_id = context.first_parms_id
    cd = context.get_context_data(parms_id)
    tool = cd.device_rns_tool
    plan = KeySwitchPlan(context, parms_id)
    C = mesh.shape["limb"]
    if plan.n_ct_rns % C != 0 or tool.base_B_size % C != 0:
        raise ValueError(
            f"n_ct={plan.n_ct_rns}/n_B={tool.base_B_size} not divisible by "
            f"limb={C}"
        )
    cc_power = plan.ct_tables.coeff_count_power
    cc = plan.ct_tables.coeff_count

    consts, specs, meta = _behz_consts(tool, plan, mesh)
    norm, norm_specs = _plan_consts(plan, mesh, key_vector_data)
    sp_rows, sp_tables = _sp_consts(plan)
    n_ct, n_b = meta["n_ct"], meta["n_b"]
    m_tilde = meta["m_tilde"]
    mt_half = np.uint64(int(m_tilde) >> 1)
    mask32 = np.uint64(0xFFFFFFFF)

    def f(a_local, b_local, c, norm_c):
        cq, ce, cr = c["q"], c["e"], c["r"]
        cm = cr["msk"]
        tab_q = _tables_from(cq["tab"], cc_power, cc)
        tab_e = _tables_from(ce["tab"], cc_power, cc)
        tab_m = _tables_from(cm["tab"], cc_power, cc)
        gather = lambda x: jax.lax.all_gather(
            x, "limb", axis=x.ndim - 2, tiled=True
        )

        def bconv_rows(g, rows):
            """q -> (rows of Bsk) contraction from gathered scaled rows."""
            return _acc128(
                ((g[..., None, i, :], rows["qbsk_mat"][:, i, None])
                 for i in range(n_ct)),
                rows["p"], rows["r0"], rows["r1"],
            )

        def sm_mrq_rows(bsk_in, x_mt, rows):
            """Montgomery reduce the given Bsk rows (rns.cpp:925-981)."""
            r = (x_mt * meta["inv_q_mt"]) & mask32
            r = (m_tilde - r) & mask32
            r_b = r[..., None, :]
            r_c = jnp.where(r_b >= mt_half, r_b + (rows["p"] - m_tilde), r_b)
            qr_hi, qr_lo = modops.mul64_wide(rows["prod_q"], r_c)
            s_lo = qr_lo + bsk_in
            s_hi = qr_hi + (s_lo < qr_lo).astype(jnp.uint64)
            acc = modops.barrett_reduce_128(
                s_hi, s_lo, rows["p"], rows["r0"], rows["r1"]
            )
            return modops.mul_mod(
                acc, rows["inv_mt"], rows["p"], rows["r0"], rows["r1"]
            )

        def extend(x):
            """x: [.., own_q, N] power basis -> (q_ntt, B_ntt, msk_ntt)."""
            q_ntt = ntt_forward_lazy(x, tab_q)
            temp = modops.mul_mod(x, m_tilde, cq["p"], cq["r0"], cq["r1"])
            scaled = modops.mul_mod(temp, cq["invp"], cq["p"], cq["r0"], cq["r1"])
            g = gather(scaled)                              # [.., n_ct, N]
            # m_tilde tag row, redundantly on every device (128-bit exact)
            mt = _acc128(
                ((g[..., None, i, :], cr["qmt_mat"][:, i, None])
                 for i in range(n_ct)),
                cr["mt_p"], cr["mt_r0"], cr["mt_r1"],
            )
            x_mt = mt[..., 0, :]
            b_rows = sm_mrq_rows(bconv_rows(g, ce), x_mt, ce)
            msk_row = sm_mrq_rows(bconv_rows(g, cm), x_mt, cm)
            return (q_ntt, ntt_forward_lazy(b_rows, tab_e),
                    ntt_forward_lazy(msk_row, tab_m))

        mmq = lambda x, y: modops.mul_mod(x, y, cq["p"], cq["r0"], cq["r1"])
        mme = lambda x, y: modops.mul_mod(x, y, ce["p"], ce["r0"], ce["r1"])
        mmm = lambda x, y: modops.mul_mod(x, y, cm["p"], cm["r0"], cm["r1"])
        addq = lambda x, y: modops.add_mod(x, y, cq["p"])

        # both components extend together (batch axis) -> ONE gather per
        # operand, as documented
        aq2, ae2, am2 = extend(a_local)
        bq2, be2, bm2 = extend(b_local)
        a0q, a1q = aq2[..., 0, :, :], aq2[..., 1, :, :]
        a0e, a1e = ae2[..., 0, :, :], ae2[..., 1, :, :]
        a0m, a1m = am2[..., 0, :, :], am2[..., 1, :, :]
        b0q, b1q = bq2[..., 0, :, :], bq2[..., 1, :, :]
        b0e, b1e = be2[..., 0, :, :], be2[..., 1, :, :]
        b0m, b1m = bm2[..., 0, :, :], bm2[..., 1, :, :]

        # size-2 x size-2 convolution per base plane (all local rows)
        def conv3(x0, x1, y0, y1, mm, add):
            return jnp.stack([
                mm(x0, y0), add(mm(x0, y1), mm(x1, y0)), mm(x1, y1),
            ], axis=-3)

        dq = conv3(a0q, a1q, b0q, b1q, mmq, lambda x, y: modops.add_mod(x, y, cq["p"]))
        de = conv3(a0e, a1e, b0e, b1e, mme, lambda x, y: modops.add_mod(x, y, ce["p"]))
        dm = conv3(a0m, a1m, b0m, b1m, mmm, lambda x, y: modops.add_mod(x, y, cm["p"]))

        q_part = ntt_inverse(dq, tab_q)
        e_part = ntt_inverse(de, tab_e)
        m_part = ntt_inverse(dm, tab_m)
        tq = mmq(q_part, meta["t"])
        te = mme(e_part, meta["t"])
        tm = mmm(m_part, meta["t"])

        # fast_floor (rns.cpp:983-1023): q -> Bsk conversion of tq
        scaled_tq = mmq(tq, cq["invp"])
        g = gather(scaled_tq)                               # [.., 3, n_ct, N]
        floor_e = mme(te + (ce["p"] - bconv_rows(g, ce)), ce["inv_prod_q"])
        floor_m = mmm(tm + (cm["p"] - bconv_rows(g, cm)), cm["inv_prod_q"])

        # fastbconv_sk (rns.cpp:853-923): B -> q, x_sk locally available
        scaled_fl = mme(floor_e, ce["invp_B"])
        g2 = gather(scaled_fl)                              # [.., 3, n_B, N]
        dest = _acc128(
            ((g2[..., None, i, :], cq["bq_mat"][:, i, None])
             for i in range(n_b)),
            cq["p"], cq["r0"], cq["r1"],
        )                                                   # [.., 3, own_q, N]
        temp_msk = _acc128(
            ((g2[..., None, i, :], cr["bmsk_mat"][:, i, None])
             for i in range(n_b)),
            meta["m_sk"], meta["msk_r0"], meta["msk_r1"],
        )[..., 0, :]
        x_sk = floor_m[..., 0, :]
        m_sk = meta["m_sk"]
        diff = temp_msk + (m_sk - x_sk)
        alpha = modops.mul_mod(
            diff, meta["inv_B_msk"], m_sk, meta["msk_r0"], meta["msk_r1"]
        )
        alpha_b = alpha[..., None, :]
        neg_term = mmq(m_sk - alpha_b, cq["prod_B"])
        pos_term = mmq(alpha_b, cq["p"] - cq["prod_B"])
        term = jnp.where(alpha_b > (m_sk >> np.uint64(1)), neg_term, pos_term)
        out = addq(dest, term)                              # [.., 3, own_q, N]

        # relinearize: explicit power-basis switch on component 2
        d0, d1 = _switch_local(
            out[..., 2, :, :], norm_c, tab_q, plan, sp_rows, sp_tables,
            is_ntt_form=False,
        )
        u0 = addq(out[..., 0, :, :], d0)
        u1 = addq(out[..., 1, :, :], d1)
        return jnp.stack([u0, u1], axis=-3)

    nd = a.ndim
    spec = _data_spec(nd, mesh, 3)

    def build():
        return shard_map(f, mesh, in_specs=(spec, spec, specs, norm_specs),
                         out_specs=spec)

    fn = _jit_cached(plan, mesh, "behz_mul_relin", nd, build)
    return fn(a, b, consts, norm)
