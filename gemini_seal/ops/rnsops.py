"""Device-side RNS operations (JAX/XLA).

JAX rework of the reference's RNSTool/BaseConverter runtime ops
(reference: native/src/seal/util/rns.cpp:452-1126).  The reference's scalar
per-coefficient loops become batched modular matmuls and fused elementwise
chains over [..., L, N] tensors:

- fast base conversion is literally out[j, n] = sum_i M[j, i] * tmp[i, n]
  mod p_j — computed here as a digit-decomposed 128-bit-exact contraction
  over the limb axis (the JAX equivalent of dot_product_mod's lazy
  128-bit accumulator, uintarithsmallmod.h:304).
- scale-and-round flows (BFV decrypt {t, gamma}, rescale divide-by-q_last)
  keep the reference's exact rounding corrections.

All constants arrive via Device* bundles built once per context level from
the host RNSTool.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..modulus import Modulus
from ..utils.rns import BaseConverter, RNSTool
from . import modops
from .backend import xp
from .dyadic import LimbConstants, add_poly, multiply_poly_scalar, sub_poly
from .ntt import NTTTables, build_ntt_tables, ntt_forward, ntt_inverse


__all__ = [
    "DeviceBaseConverter",
    "DeviceRNSTool",
    "fast_convert_array",
    "decrypt_scale_and_round",
    "divide_and_round_q_last",
    "MultiDropPlan",
    "divide_and_round_multi",
    "divide_and_round_q_last_ntt",
    "multiply_add_plain_with_scaling_variant",
    "multiply_sub_plain_with_scaling_variant",
    "sm_mrq",
    "fast_floor",
    "fastbconv_sk",
    "fastbconv_m_tilde",
]


@dataclass(frozen=True)
class DeviceBaseConverter:
    """Device twin of a host BaseConverter."""

    ibase: LimbConstants
    obase: LimbConstants
    matrix: np.ndarray           # u64[O, I]
    inv_punctured: np.ndarray    # u64[I, 1]

    @staticmethod
    def from_host(conv: BaseConverter) -> "DeviceBaseConverter":
        return DeviceBaseConverter(
            ibase=LimbConstants.from_moduli(conv.ibase.base),
            obase=LimbConstants.from_moduli(conv.obase.base),
            matrix=np.asarray(conv.matrix),
            inv_punctured=np.asarray(conv.inv_punctured.reshape(-1, 1)),
        )


def _dot_mod_128(a, b, obase: LimbConstants):
    """sum_i a[..., i, n] * b[j, i] mod p_j -> [..., O, N].

    128-bit-exact contraction over the (small) input-base axis via the
    shared digit-plane accumulator (modops.accumulate_mulmod_128) —
    the vectorized equivalent of the reference's FMAU128 lazy accumulator +
    barrett_reduce_128.  Accumulating per input limb keeps live
    intermediates at [..., O, N] instead of materializing the full
    [..., O, I, N] broadcast product.
    """
    I = a.shape[-2]
    return modops.accumulate_mulmod_128(
        ((a[..., None, i, :], b[:, i, None]) for i in range(I)),
        obase.p, obase.ratio0, obase.ratio1,
    )


def fast_convert_array(x, conv: DeviceBaseConverter):
    """BEHZ FastBConv: [..., I, N] residues -> [..., O, N]
    (reference: rns.cpp:498-523)."""
    temp = modops.mul_mod(
        x, conv.inv_punctured, conv.ibase.p, conv.ibase.ratio0, conv.ibase.ratio1
    )
    return _dot_mod_128(temp, conv.matrix, conv.obase)


class DeviceRNSTool:
    """Constant bundle twin of the host RNSTool (converters + scalars)."""

    def __init__(self, host: RNSTool):
        self.host = host
        self.coeff_count = host.coeff_count
        q = host.base_q
        self.base_q_size = q.size
        self.q_limbs = LimbConstants.from_moduli(q.base)
        self.base_B_size = host.base_B.size
        self.base_Bsk_size = host.base_Bsk.size
        self.Bsk_limbs = LimbConstants.from_moduli(host.base_Bsk.base)
        self.Bsk_m_tilde_limbs = LimbConstants.from_moduli(host.base_Bsk_m_tilde.base)
        self.q_to_Bsk = DeviceBaseConverter.from_host(host.base_q_to_Bsk_conv)
        self.q_to_m_tilde = DeviceBaseConverter.from_host(host.base_q_to_m_tilde_conv)
        self.B_to_q = DeviceBaseConverter.from_host(host.base_B_to_q_conv)
        self.B_to_m_sk = DeviceBaseConverter.from_host(host.base_B_to_m_sk_conv)
        self.m_sk = host.m_sk
        self.m_tilde = host.m_tilde
        self.gamma = host.gamma
        self.t = host.t
        self.prod_B_mod_q = np.asarray(host.prod_B_mod_q.reshape(-1, 1))
        self.inv_prod_q_mod_Bsk = np.asarray(host.inv_prod_q_mod_Bsk.reshape(-1, 1))
        self.inv_prod_B_mod_m_sk = np.uint64(host.inv_prod_B_mod_m_sk)
        self.inv_m_tilde_mod_Bsk = np.asarray(host.inv_m_tilde_mod_Bsk.reshape(-1, 1))
        self.inv_prod_q_mod_m_tilde = np.uint64(host.inv_prod_q_mod_m_tilde)
        self.prod_q_mod_Bsk = np.asarray(host.prod_q_mod_Bsk.reshape(-1, 1))
        self.inv_q_last_mod_q = np.asarray(host.inv_q_last_mod_q.reshape(-1, 1))
        # Bsk NTT tables (for BFV multiply)
        n = host.coeff_count
        log_n = n.bit_length() - 1
        self.base_Bsk_ntt_tables: NTTTables = build_ntt_tables(
            log_n, host.base_Bsk.base
        )
        if host.base_t_gamma is not None:
            self.t_gamma_limbs = LimbConstants.from_moduli(host.base_t_gamma.base)
            self.q_to_t_gamma = DeviceBaseConverter.from_host(
                host.base_q_to_t_gamma_conv
            )
            self.inv_gamma_mod_t = np.uint64(host.inv_gamma_mod_t)
            self.prod_t_gamma_mod_q = np.asarray(
                host.prod_t_gamma_mod_q.reshape(-1, 1)
            )
            self.neg_inv_q_mod_t_gamma = np.asarray(
                host.neg_inv_q_mod_t_gamma.reshape(-1, 1)
            )
            self.t_modulus = Modulus(host.t.value)


def decrypt_scale_and_round(x, tool: DeviceRNSTool):
    """BFV decrypt tail: round(t/q * x) mod t via the {t, gamma} trick
    (reference: rns.cpp:1070-1126).  x: [..., L, N] -> [..., N] mod t.
    """
    t = tool.t.value
    gamma = tool.gamma.value
    t_mod = tool.t_modulus
    # |gamma * t|_qi * x
    temp = modops.mul_mod(
        x, tool.prod_t_gamma_mod_q, tool.q_limbs.p, tool.q_limbs.ratio0, tool.q_limbs.ratio1
    )
    tg = fast_convert_array(temp, tool.q_to_t_gamma)       # [..., 2, N]
    tg = modops.mul_mod(
        tg,
        tool.neg_inv_q_mod_t_gamma,
        tool.t_gamma_limbs.p,
        tool.t_gamma_limbs.ratio0,
        tool.t_gamma_limbs.ratio1,
    )
    t_part = tg[..., 0, :]
    g_part = tg[..., 1, :]
    m_ = xp(x)
    gamma_div_2 = np.uint64(gamma >> 1)
    t_r1 = np.uint64(t_mod.const_ratio[1])
    t_u = np.uint64(t)
    # centered correction on the gamma component
    corr_pos = modops.barrett_reduce_64(np.uint64(gamma) - g_part, t_u, t_r1)
    corr_neg = modops.barrett_reduce_64(g_part, t_u, t_r1)
    dest = m_.where(
        g_part > gamma_div_2,
        modops.add_mod(t_part, corr_pos, t_u),
        modops.sub_mod(t_part, corr_neg, t_u),
    )
    r0 = np.uint64(t_mod.const_ratio[0])
    return modops.mul_mod(dest, tool.inv_gamma_mod_t, t_u, r0, t_r1)


def divide_and_round_q_last(x, tool: DeviceRNSTool):
    """Drop the last limb with rounding: [..., L, N] -> [..., L-1, N]
    (reference: rns.cpp:731-775).  Non-NTT-form inputs."""
    L = x.shape[-2]
    q = tool.q_limbs
    last_p = q.p[L - 1, 0]
    last_r1 = q.ratio1[L - 1, 0]
    half = last_p >> np.uint64(1)
    rest_p = q.p[: L - 1]
    rest_r1 = q.ratio1[: L - 1]
    rest_r0 = q.ratio0[: L - 1]
    rest = x[..., : L - 1, :]

    last = modops.barrett_reduce_64(x[..., L - 1, :] + half, last_p, last_r1)
    # (ct mod qk) mod qi, minus half mod qi
    last_mod_qi = modops.barrett_reduce_64(last[..., None, :], rest_p, rest_r1)
    half_mod_qi = modops.barrett_reduce_64(half, rest_p, rest_r1)
    temp = modops.sub_mod(last_mod_qi, half_mod_qi, rest_p)
    diff = modops.sub_mod(rest, temp, rest_p)
    return modops.mul_mod(diff, tool.inv_q_last_mod_q, rest_p, rest_r0, rest_r1)


def divide_and_round_q_last_ntt(x, tool: DeviceRNSTool, tables: NTTTables,
                                ntt=None):
    """NTT-domain variant (reference: rns.cpp:777-851): iNTT the last limb,
    round, lift back per remaining limb with a forward NTT, subtract,
    multiply by q_last^{-1}.

    `ntt` optionally swaps the transform entry points (keyswitch.NTTOps) —
    the coeff-sharded pipeline passes the all_to_all four-step bodies."""
    fwd = ntt_forward if ntt is None else ntt.forward
    inv = ntt_inverse if ntt is None else ntt.inverse
    L = x.shape[-2]
    q = tool.q_limbs
    last_p = q.p[L - 1, 0]
    last_r1 = q.ratio1[L - 1, 0]
    half = last_p >> np.uint64(1)
    rest_p = q.p[: L - 1]
    rest_r0 = q.ratio0[: L - 1]
    rest_r1 = q.ratio1[: L - 1]
    rest = x[..., : L - 1, :]

    last_tables = _slice_tables(tables, L - 1, L)
    rest_tables = _slice_tables(tables, 0, L - 1)

    last = inv(x[..., L - 1 : L, :], last_tables)  # [..., 1, N]
    last = modops.barrett_reduce_64(last[..., 0, :] + half, last_p, last_r1)
    # reduce into each remaining limb, subtract half, NTT forward
    last_mod_qi = modops.barrett_reduce_64(last[..., None, :], rest_p, rest_r1)
    half_mod_qi = modops.barrett_reduce_64(half, rest_p, rest_r1)
    temp = modops.sub_mod(last_mod_qi, half_mod_qi, rest_p)
    temp = fwd(temp, rest_tables)
    diff = modops.sub_mod(rest, temp, rest_p)
    return modops.mul_mod(diff, tool.inv_q_last_mod_q, rest_p, rest_r0, rest_r1)


def _slice_tables(t: NTTTables, lo: int, hi: int) -> NTTTables:
    """View of a limb range of stacked NTT tables."""
    return NTTTables(
        coeff_count_power=t.coeff_count_power,
        coeff_count=t.coeff_count,
        moduli=t.moduli[lo:hi],
        roots=t.roots[lo:hi],
        root_powers=t.root_powers[lo:hi],
        scaled_root_powers=t.scaled_root_powers[lo:hi],
        inv_root_powers=t.inv_root_powers[lo:hi],
        scaled_inv_root_powers=t.scaled_inv_root_powers[lo:hi],
        inv_degree_modulo=t.inv_degree_modulo[lo:hi],
        scaled_inv_degree=t.scaled_inv_degree[lo:hi],
        reduce_precomp=t.reduce_precomp[lo:hi],
        modulus=t.modulus[lo:hi],
    )


def multiply_add_plain_with_scaling_variant(c0, plain, context_data):
    """c0 += round(q/t * m): Delta*m plus the exact rounding fix
    (reference: scalingvariant.cpp:15-52).

    c0: [..., L, N]; plain: u64[N] mod t (zero-padded).  Returns new c0.
    """
    t = context_data.parms.plain_modulus
    t_u = np.uint64(t.value)
    q_mod_t = np.uint64(context_data.coeff_modulus_mod_plain_modulus)
    thresh = np.uint64(context_data.plain_upper_half_threshold)
    delta = np.asarray(context_data.coeff_div_plain_modulus.reshape(-1, 1))
    limbs = context_data.limb_constants

    m_ = xp(c0, plain)
    m = m_.asarray(plain, dtype=m_.uint64)
    prod_hi, prod_lo = modops.mul64_wide(m, q_mod_t)
    num_lo = prod_lo + thresh
    carry = (num_lo < prod_lo).astype(m_.uint64)
    num_hi = prod_hi + carry
    fix, _ = modops.divmod_128(
        num_hi, num_lo, t_u, np.uint64(t.const_ratio[0]), np.uint64(t.const_ratio[1])
    )  # [N]
    # (Delta_j * m_i + fix_i) mod q_j
    dm_hi, dm_lo = modops.mul64_wide(delta, m[..., None, :])
    s_lo = dm_lo + fix[..., None, :]
    s_carry = (s_lo < dm_lo).astype(m_.uint64)
    s_hi = dm_hi + s_carry
    inc = modops.barrett_reduce_128(s_hi, s_lo, limbs.p, limbs.ratio0, limbs.ratio1)
    return modops.add_mod(c0, inc, limbs.p)


def multiply_sub_plain_with_scaling_variant(c0, plain, context_data):
    """c0 -= round(q/t * m) (reference: scalingvariant.cpp:54-92)."""
    t = context_data.parms.plain_modulus
    t_u = np.uint64(t.value)
    q_mod_t = np.uint64(context_data.coeff_modulus_mod_plain_modulus)
    thresh = np.uint64(context_data.plain_upper_half_threshold)
    delta = np.asarray(context_data.coeff_div_plain_modulus.reshape(-1, 1))
    limbs = context_data.limb_constants

    m_ = xp(c0, plain)
    m = m_.asarray(plain, dtype=m_.uint64)
    prod_hi, prod_lo = modops.mul64_wide(m, q_mod_t)
    num_lo = prod_lo + thresh
    carry = (num_lo < prod_lo).astype(m_.uint64)
    num_hi = prod_hi + carry
    fix, _ = modops.divmod_128(
        num_hi, num_lo, t_u, np.uint64(t.const_ratio[0]), np.uint64(t.const_ratio[1])
    )
    dm_hi, dm_lo = modops.mul64_wide(delta, m[..., None, :])
    s_lo = dm_lo + fix[..., None, :]
    s_carry = (s_lo < dm_lo).astype(m_.uint64)
    s_hi = dm_hi + s_carry
    dec = modops.barrett_reduce_128(s_hi, s_lo, limbs.p, limbs.ratio0, limbs.ratio1)
    return modops.sub_mod(c0, dec, limbs.p)


# ---------------------------------------------------------------------------
# BFV-multiply (BEHZ) support ops
# ---------------------------------------------------------------------------

def fastbconv_m_tilde(x, tool: DeviceRNSTool):
    """q -> Bsk u {m_tilde} with the m_tilde premultiplication
    (reference: rns.cpp:1025-1068).  [..., L, N] -> [..., Bsk+1, N]."""
    q = tool.q_limbs
    temp = modops.mul_mod(
        x, np.uint64(tool.m_tilde.value), q.p, q.ratio0, q.ratio1
    )
    to_bsk = fast_convert_array(temp, tool.q_to_Bsk)
    to_m_tilde = fast_convert_array(temp, tool.q_to_m_tilde)
    return xp(x).concatenate([to_bsk, to_m_tilde], axis=-2)


def sm_mrq(x, tool: DeviceRNSTool):
    """Montgomery reduction Bsk u {m_tilde} -> Bsk
    (reference: rns.cpp:925-981).  [..., Bsk+1, N] -> [..., Bsk, N]."""
    m_ = xp(x)
    bsk = tool.Bsk_limbs
    m_tilde = np.uint64(tool.m_tilde.value)
    m_tilde_div_2 = m_tilde >> np.uint64(1)
    x_bsk = x[..., : tool.base_Bsk_size, :]
    x_mt = x[..., tool.base_Bsk_size, :]

    # r_m_tilde = -(x_mt / q) mod m_tilde ; m_tilde = 2^32 so plain masking
    r = (x_mt * tool.inv_prod_q_mod_m_tilde) & np.uint64(0xFFFFFFFF)
    r = (m_tilde - r) & np.uint64(0xFFFFFFFF)
    # centered: if r >= m_tilde/2, use r - m_tilde (add p - m_tilde per limb)
    r_b = r[..., None, :]
    r_centered = m_.where(
        r_b >= m_tilde_div_2, r_b + (bsk.p - m_tilde), r_b
    )
    # (x + q * r) * m_tilde^{-1} mod Bsk
    qr_hi, qr_lo = modops.mul64_wide(tool.prod_q_mod_Bsk, r_centered)
    s_lo = qr_lo + x_bsk
    s_carry = (s_lo < qr_lo).astype(m_.uint64)
    s_hi = qr_hi + s_carry
    acc = modops.barrett_reduce_128(s_hi, s_lo, bsk.p, bsk.ratio0, bsk.ratio1)
    return modops.mul_mod(acc, tool.inv_m_tilde_mod_Bsk, bsk.p, bsk.ratio0, bsk.ratio1)


def fast_floor(x_q, x_bsk, tool: DeviceRNSTool):
    """floor(x / q): input in q u Bsk -> output in Bsk
    (reference: rns.cpp:983-1023)."""
    bsk = tool.Bsk_limbs
    conv = fast_convert_array(x_q, tool.q_to_Bsk)
    # (x_bsk - conv) * q^{-1} mod Bsk ; the un-reduced difference is fine,
    # mul_mod takes full 64-bit operands.
    diff = x_bsk + (bsk.p - conv)
    return modops.mul_mod(
        diff, tool.inv_prod_q_mod_Bsk, bsk.p, bsk.ratio0, bsk.ratio1
    )


def fastbconv_sk(x_bsk, tool: DeviceRNSTool):
    """Shenoy-Kumaresan Bsk -> q (reference: rns.cpp:853-923)."""
    m_ = xp(x_bsk)
    q = tool.q_limbs
    m_sk = np.uint64(tool.m_sk.value)
    x_B = x_bsk[..., : tool.base_B_size, :]
    x_sk = x_bsk[..., tool.base_B_size, :]

    dest = fast_convert_array(x_B, tool.B_to_q)           # [..., L, N]
    temp = fast_convert_array(x_B, tool.B_to_m_sk)[..., 0, :]  # [..., N]
    # alpha_sk = (temp - x_sk) * B^{-1} mod m_sk
    msk_mod = tool.m_sk
    r0 = np.uint64(msk_mod.const_ratio[0])
    r1 = np.uint64(msk_mod.const_ratio[1])
    diff = temp + (m_sk - x_sk)
    alpha = modops.mul_mod(diff, tool.inv_prod_B_mod_m_sk, m_sk, r0, r1)

    m_sk_div_2 = m_sk >> np.uint64(1)
    alpha_b = alpha[..., None, :]
    # negative branch: dest += prod_B * (m_sk - alpha) mod q
    # positive branch: dest += (q - prod_B) * alpha mod q
    neg_term = modops.mul_mod(
        (m_sk - alpha_b), tool.prod_B_mod_q, q.p, q.ratio0, q.ratio1
    )
    pos_term = modops.mul_mod(
        alpha_b, q.p - tool.prod_B_mod_q, q.p, q.ratio0, q.ratio1
    )
    term = m_.where(alpha_b > m_sk_div_2, neg_term, pos_term)
    return modops.add_mod(dest, term, q.p)


def crt_drop_constants(d_moduli, out_moduli):
    """Shared CRT constants for dividing by Q_D = prod(d_moduli) while
    keeping out_moduli: per-d punctured-product inverses, the hat matrix
    (Q_D/d_j) mod q_i, and inv(Q_D) mod q_i.  Used by the fused key-switch
    mod-down (ops.keyswitch) and the fused multi-level mod-switch below."""
    from ..utils import numth

    q_d = 1
    for d in d_moduli:
        q_d *= d
    nd, no = len(d_moduli), len(out_moduli)
    inv_hat = np.zeros(nd, dtype=np.uint64)
    for j, dj in enumerate(d_moduli):
        r = numth.try_invert_uint_mod((q_d // dj) % dj, dj)
        if r is None:
            raise ValueError("drop base: punctured product not invertible")
        inv_hat[j] = r
    hat_qi = np.zeros((no, nd), dtype=np.uint64)
    inv_qd = np.zeros(no, dtype=np.uint64)
    for i, qi in enumerate(out_moduli):
        for j, dj in enumerate(d_moduli):
            hat_qi[i, j] = (q_d // dj) % qi
        r = numth.try_invert_uint_mod(q_d % qi, qi)
        if r is None:
            raise ValueError("drop base: Q_D not invertible")
        inv_qd[i] = r
    return q_d, inv_hat, hat_qi, inv_qd


class MultiDropPlan:
    """Constants for the fused multi-level BFV mod-switch: ONE rounded
    division by Q_D = prod(dropped primes) instead of a per-level chain of
    divide_and_round_q_last calls (no reference analogue; the sequential
    chain is evaluator.cpp mod_switch_to_inplace).  The approximate CRT
    interpolation adds at most |D| to the quotient — bounded sub-noise, so
    results decrypt identically."""

    def __init__(self, context, parms_id, levels: int):
        cd = context.get_context_data(parms_id)
        if cd is None:
            raise ValueError("parms_id is not valid for the context")
        moduli = [m.value for m in cd.parms.coeff_modulus]
        L = len(moduli)
        if not 1 <= levels < L:
            raise ValueError("levels must drop at least one and keep one prime")
        self.levels = levels
        d_moduli = moduli[L - levels:]
        out_moduli = moduli[: L - levels]
        q_d, inv_hat, hat_qi, inv_qd = crt_drop_constants(d_moduli, out_moduli)
        half = q_d >> 1
        half_d = np.array([half % d for d in d_moduli], dtype=np.uint64)
        half_qi = np.array([half % q for q in out_moduli], dtype=np.uint64)

        self.d_limbs = LimbConstants.from_moduli(d_moduli)
        self.out_limbs = LimbConstants.from_moduli(out_moduli)
        self.inv_hat_d = inv_hat.reshape(-1, 1)
        self.half_d = half_d.reshape(-1, 1)
        self.hat_d_qi = hat_qi
        self.inv_qd_qi = inv_qd.reshape(-1, 1)
        self.half_qi = half_qi.reshape(-1, 1)
        self.n_out = len(out_moduli)


def divide_and_round_multi(x, plan: MultiDropPlan):
    """Fused rounded division by Q_D (power-basis input):
    y_i = (x_i - [(x + Q_D/2) mod Q_D] + Q_D/2) * Q_D^{-1} mod q_i,
    with the bracket CRT-interpolated from the dropped limbs.
    [..., L, N] -> [..., L - levels, N]."""
    no = plan.n_out
    rest = x[..., :no, :]
    dl = plan.d_limbs
    ol = plan.out_limbs

    shifted = modops.add_mod(x[..., no:, :], plan.half_d, dl.p)
    scaled = modops.mul_mod(shifted, plan.inv_hat_d, dl.p, dl.ratio0, dl.ratio1)
    interp = _dot_mod_128(scaled, plan.hat_d_qi, ol)      # [..., no, N]
    temp = modops.sub_mod(interp, plan.half_qi, ol.p)
    diff = modops.sub_mod(rest, temp, ol.p)
    return modops.mul_mod(diff, plan.inv_qd_qi, ol.p, ol.ratio0, ol.ratio1)
