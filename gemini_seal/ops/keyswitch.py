"""Hybrid multi-special-prime key switching (JAX/XLA).

JAX rework of the fork's headline feature
(reference: native/src/seal/multi_special_primes.cpp:1-305 and
Evaluator::switch_key_inplace, evaluator.cpp:2259-2368):

- bundle-wise mod-up: CRT-interpolate each decomposition bundle of the
  target polynomial onto all other normal limbs and the special limbs —
  here a batched modular matmul (the same 128-bit digit contraction as base
  conversion) instead of scalar Shoup/FMA loops;
- key inner product: sum over bundles of ct_bundle[k] * evk_bundle[l][k]
  in the NTT domain with 128-bit-exact accumulation;
- special-prime rescale (mod-down): divide by P = prod(special primes) with
  the fork's interpolation correction, then add into the ciphertext.

Deviation from the reference: the fork's step 3 feeds the *power-basis*
target into the inner product for the bundle-diagonal limbs when the scheme
is BFV, which breaks BFV relinearization/rotation (verified against the
compiled fork: noise budget collapses to 0).  Here the diagonal limbs are
NTT-transformed for BFV, so key switching is correct for both schemes.
"""

from __future__ import annotations

import numpy as np

from ..utils import numth
from . import modops
from .backend import xp
from .dyadic import LimbConstants
from .ntt import (NTTTables, ntt_forward, ntt_forward_lazy, ntt_inverse,
                  ntt_inverse_lazy)
from .rnsops import _dot_mod_128, _slice_tables

__all__ = ["KeySwitchPlan", "switch_key", "compute_modup_digits",
           "keyswitch_inner_product", "batched_rotated_inner_product",
           "fused_moddown", "NTTOps", "IN_CORE_NTT"]


class NTTOps:
    """Pluggable NTT strategy: the key-switch dataflow is identical in-core
    and under coefficient sharding — only the four transform entry points
    differ (parallel/pipeline_csp.py passes the all_to_all four-step
    bodies).  Defaults to the in-core ops.ntt transforms."""

    forward = staticmethod(ntt_forward)
    forward_lazy = staticmethod(ntt_forward_lazy)
    inverse = staticmethod(ntt_inverse)
    inverse_lazy = staticmethod(ntt_inverse_lazy)


IN_CORE_NTT = NTTOps()


def _gather_tables(t: NTTTables, idx) -> NTTTables:
    idx = np.asarray(idx, dtype=np.int64)
    return NTTTables(
        coeff_count_power=t.coeff_count_power,
        coeff_count=t.coeff_count,
        moduli=[t.moduli[i] for i in idx],
        roots=t.roots[idx],
        root_powers=t.root_powers[idx],
        scaled_root_powers=t.scaled_root_powers[idx],
        inv_root_powers=t.inv_root_powers[idx],
        scaled_inv_root_powers=t.scaled_inv_root_powers[idx],
        inv_degree_modulo=t.inv_degree_modulo[idx],
        scaled_inv_degree=t.scaled_inv_degree[idx],
        reduce_precomp=t.reduce_precomp[idx],
        modulus=t.modulus[idx],
    )


class KeySwitchPlan:
    """Per-(ciphertext level, key level) constants for hybrid key switching.

    Precomputes, with exact ints, the bundle mod-up matrices and the
    special-prime rescale constants (multi_special_primes.cpp:109-141,
    186-234, 244-248, 291-299).
    """

    def __init__(self, context, parms_id):
        cd = context.get_context_data(parms_id)
        key_cd = context.key_context_data()
        first_cd = context.first_context_data()
        key_modulus = [m.value for m in key_cd.parms.coeff_modulus]

        self.n_ct_rns = len(cd.parms.coeff_modulus)
        self.n_ct_all_rns = len(first_cd.parms.coeff_modulus)
        self.n_total_rns = len(key_modulus)
        self.n_sp_rns = self.n_total_rns - self.n_ct_all_rns
        self.n_bundles = (self.n_ct_rns + self.n_sp_rns - 1) // self.n_sp_rns
        n_ct, n_sp = self.n_ct_rns, self.n_sp_rns

        # Extended limb set: normal limbs at this level + the special limbs.
        self.ext_key_indices = np.array(
            list(range(n_ct))
            + list(range(self.n_ct_all_rns, self.n_ct_all_rns + n_sp)),
            dtype=np.int64,
        )
        ext_moduli = [key_modulus[i] for i in self.ext_key_indices]
        self.ext_moduli = ext_moduli
        self.n_ext = len(ext_moduli)
        self.ext_limbs = LimbConstants.from_moduli(ext_moduli)
        self.ct_limbs = LimbConstants.from_moduli(ext_moduli[:n_ct])
        self.ext_tables = _gather_tables(key_cd.ntt_tables, self.ext_key_indices)
        self.ct_tables = _slice_tables(self.ext_tables, 0, n_ct)

        # Bundle mod-up data (modup_to_single_rns, :109-141): for bundle b
        # with limb set S, matrix[dst, i] = (Q_S / q_i) mod p_dst and
        # inv[i] = (Q_S / q_i)^{-1} mod q_i.  Diagonal rows (dst in S) are
        # unused (masked by the caller).
        self.bundles = []
        for b in range(self.n_bundles):
            rns0 = b * n_sp
            rns1 = min(rns0 + n_sp, n_ct)
            S = list(range(rns0, rns1))
            inv = np.zeros(len(S), dtype=np.uint64)
            mat = np.zeros((self.n_ext, len(S)), dtype=np.uint64)
            for a, i in enumerate(S):
                qi = ext_moduli[i]
                punc = 1
                for j in S:
                    if j != i:
                        punc *= ext_moduli[j]
                inv_a = numth.try_invert_uint_mod(punc % qi, qi)
                if inv_a is None:
                    raise ValueError("key-switch modup: punctured product not invertible")
                inv[a] = inv_a
                for dst in range(self.n_ext):
                    mat[dst, a] = punc % ext_moduli[dst]
            self.bundles.append((rns0, rns1, inv.reshape(-1, 1), mat))

        # Stacked (bundle-batched) mod-up constants: one gather + one batched
        # modular matmul + one batched NTT cover every bundle at once.  The
        # last bundle may be short (n_ct % n_sp != 0); its padding columns use
        # inv = 0 so they contribute nothing, with clamped gather indices.
        s_max = max(r1 - r0 for r0, r1, _, _ in self.bundles)
        self.bundle_sel = np.zeros((self.n_bundles, s_max), dtype=np.int64)
        self.bundle_inv = np.zeros((self.n_bundles, s_max, 1), dtype=np.uint64)
        self.bundle_mat = np.zeros(
            (self.n_bundles, self.n_ext, s_max), dtype=np.uint64
        )
        self.bundle_diag = np.zeros((self.n_bundles, self.n_ext, 1), dtype=bool)
        for b, (rns0, rns1, inv, mat) in enumerate(self.bundles):
            s = rns1 - rns0
            self.bundle_sel[b, :s] = np.arange(rns0, rns1)
            self.bundle_inv[b, :s] = inv
            self.bundle_mat[b, :, :s] = mat
            self.bundle_diag[b, rns0:rns1, 0] = True
        # per-(bundle, slot) modulus constants for the pre-multiply
        self.bundle_p = self.ct_limbs.p[self.bundle_sel.ravel()].reshape(
            self.n_bundles, s_max, 1
        )
        self.bundle_r0 = self.ct_limbs.ratio0[self.bundle_sel.ravel()].reshape(
            self.n_bundles, s_max, 1
        )
        self.bundle_r1 = self.ct_limbs.ratio1[self.bundle_sel.ravel()].reshape(
            self.n_bundles, s_max, 1
        )

        # Special-prime rescale constants (:186-234, 291-299).
        sp0 = self.n_ct_all_rns
        sp_moduli = [key_modulus[sp0 + j] for j in range(n_sp)]
        inv_hat = np.zeros(n_sp, dtype=np.uint64)
        for j in range(n_sp):
            prod = 1
            for k in range(n_sp):
                if k != j:
                    prod = (prod * sp_moduli[k]) % sp_moduli[j]
            r = numth.try_invert_uint_mod(prod, sp_moduli[j])
            if r is None:
                raise ValueError("key-switch rescale: inverse failed")
            inv_hat[j] = r
        self.inv_hat_pj_pj = inv_hat.reshape(-1, 1)
        self.sp_limbs = LimbConstants.from_moduli(sp_moduli)

        neg_hat = np.zeros((n_ct, n_sp), dtype=np.uint64)
        invP = np.zeros(n_ct, dtype=np.uint64)
        for i in range(n_ct):
            qi = ext_moduli[i]
            for j in range(n_sp):
                prod = 1
                for k in range(n_sp):
                    if k != j:
                        prod = (prod * sp_moduli[k]) % qi
                neg_hat[i, j] = (-prod) % qi
            P_qi = 1
            for j in range(n_sp):
                P_qi = (P_qi * sp_moduli[j]) % qi
            r = numth.try_invert_uint_mod(P_qi, qi)
            if r is None:
                raise ValueError("key-switch rescale: P not invertible")
            invP[i] = r
        self.neg_hat_pj_qi = neg_hat                   # [n_ct, n_sp]
        self.inv_P_qi = invP.reshape(-1, 1)
        self._ext_moduli = ext_moduli
        self._sp_moduli = sp_moduli
        self._fused = None
        # level's RNS tool: the sharded pipeline reuses its rescale
        # constants (inv_q_last_mod_q) instead of re-deriving them
        self.device_rns_tool = cd.device_rns_tool

        # Lazy-digit safety margin (exact-int check at plan build): every
        # constructible context passes (user primes are <= 59 bits and
        # bundle counts <= 64, so n_bundles * 4p^2 < 2^126), but the gate
        # keeps the accumulator contract explicit and survives any future
        # widening of the user modulus limit.
        self.lazy_digits = self._lazy_digits_safe(self.n_bundles, max(ext_moduli))

    @staticmethod
    def _lazy_digits_safe(n_bundles: int, max_p: int) -> bool:
        """True iff the inner product may consume lazy [0, 4p) digits: it
        accumulates n_bundles terms of ct_k * key per output limb, and the
        worst-case sum n_bundles * 4p * p must stay below 2^128 for the
        128-bit renormalization to be exact (canonical digits have a 4x
        wider margin)."""
        return n_bundles * 4 * max_p * max_p < (1 << 128)

    def fused_drop_constants(self):
        """Constants for the fused mod-down by Q_D = P * q_last (dropping
        the special primes AND the level's last ciphertext prime in ONE
        interpolation pass) — no reference analogue; the sequential
        equivalent is rescale_special followed by divide_and_round_q_last.

        D's limb rows are contiguous in the extended layout:
        [n_ct-1 (q_last), n_ct .. n_ext-1 (specials)].
        """
        if self._fused is not None:
            return self._fused
        n_ct = self.n_ct_rns
        if n_ct < 2:
            raise ValueError("fused rescale needs at least two ct primes")
        d_moduli = [self._ext_moduli[n_ct - 1]] + list(self._sp_moduli)
        out_moduli = self._ext_moduli[: n_ct - 1]
        from .rnsops import crt_drop_constants

        q_d, inv_hat, hat_qi, inv_qd = crt_drop_constants(d_moduli, out_moduli)
        neg_hat = np.zeros_like(hat_qi)
        for i, qi in enumerate(out_moduli):
            for j in range(len(d_moduli)):
                neg_hat[i, j] = (qi - hat_qi[i, j]) % qi
        P = 1
        for p in self._sp_moduli:
            P *= p
        p_mod = np.array([P % self._ext_moduli[i] for i in range(n_ct)],
                         dtype=np.uint64)

        self._fused = {
            "d_limbs": LimbConstants.from_moduli(d_moduli),
            "d_tables": _slice_tables(self.ext_tables, n_ct - 1, self.n_ext),
            "out_limbs": LimbConstants.from_moduli(out_moduli),
            "out_tables": _slice_tables(self.ext_tables, 0, n_ct - 1),
            "inv_hat_d": inv_hat.reshape(-1, 1),
            "neg_hat_d_qi": neg_hat,
            "inv_qd_qi": inv_qd.reshape(-1, 1),
            "p_mod_qi": p_mod.reshape(-1, 1),
        }
        return self._fused


def rescale_special(ext_poly_ntt, plan: KeySwitchPlan, is_ntt_output: bool,
                    ntt: NTTOps = IN_CORE_NTT):
    """Mod-down by P = prod(special primes) (multi_special_primes.cpp:237-304).

    ext_poly_ntt: [n_ext, N] with ALL limbs in NTT domain (the inner-product
    output).  Returns [n_ct, N] in NTT domain if is_ntt_output (CKKS) else
    power basis (BFV).
    """
    n_ct = plan.n_ct_rns
    sp = ext_poly_ntt[..., n_ct:, :]
    normal = ext_poly_ntt[..., :n_ct, :]

    # special limbs to power basis — [0, 2p) lazy is fine: the only
    # consumer is the full-range Barrett mul_mod below
    sp_tables = _slice_tables(plan.ext_tables, n_ct, plan.n_ext)
    sp_power = ntt.inverse_lazy(sp, sp_tables)

    # temp_i = sum_j (ct_pj * hat_pj^{-1} mod pj) * (-hat_pj mod qi)
    scaled = modops.mul_mod(
        sp_power, plan.inv_hat_pj_pj, plan.sp_limbs.p, plan.sp_limbs.ratio0, plan.sp_limbs.ratio1
    )  # [n_sp, N]
    temp = _dot_mod_128(scaled, plan.neg_hat_pj_qi, plan.ct_limbs)  # [n_ct, N]

    q = plan.ct_limbs
    if is_ntt_output:
        temp = ntt.forward(temp, plan.ct_tables)
        acc = modops.add_mod(normal, temp, q.p)
    else:
        normal_power = ntt.inverse(normal, plan.ct_tables)
        acc = modops.add_mod(normal_power, temp, q.p)
    return modops.mul_mod(acc, plan.inv_P_qi, q.p, q.ratio0, q.ratio1)


def compute_modup_digits(target, plan: KeySwitchPlan, is_ntt_form: bool,
                         ntt: NTTOps = IN_CORE_NTT):
    """Bundle-batched mod-up digit decomposition: [..., n_ct, N] target ->
    [..., n_bundles, n_ext, N] NTT-domain digit polynomials (ct_k).

    Gathers every bundle's limb set, pre-multiplies by the punctured-product
    inverses, CRT-contracts, and runs ONE batched NTT (same math as
    modup_rns, multi_special_primes.cpp:151-185).  Diagonal limbs use the
    original NTT-domain target (exact, no lift).

    This is the expensive half of a key switch; rotation hoisting reuses it
    across many Galois elements (see hoisted_galois_keyswitch).
    """
    n_ct, n_ext = plan.n_ct_rns, plan.n_ext
    N = target.shape[-1]
    batch = target.shape[:-2]
    m_ = xp(target)

    # Lazy chaining (reference ntt.cpp:341/403 *_lazy dataflow): the inverse
    # NTT output stays in [0, 2p) — its only consumer is the bundle
    # pre-multiply's full-range Barrett mul_mod, so the canonical reduction
    # pass is pure overhead.  Same for the forward lifts below ([0, 4p)):
    # ct_k is consumed by the 128-bit inner-product accumulation, which
    # Barrett-reduces exactly from any range.  Outputs are bit-identical.
    power_target = (
        ntt.inverse_lazy(target, plan.ct_tables) if is_ntt_form else target
    )
    if is_ntt_form:
        ntt_target = target
    elif plan.lazy_digits:
        ntt_target = ntt.forward_lazy(target, plan.ct_tables)
    else:
        ntt_target = ntt.forward(target, plan.ct_tables)
    pad_width = [(0, 0)] * len(batch) + [(0, n_ext - n_ct), (0, 0)]
    ntt_target_ext = m_.pad(ntt_target, pad_width)

    nb, s_max = plan.bundle_sel.shape
    x_sel = m_.take(power_target, plan.bundle_sel.ravel(), axis=-2)
    x_sel = x_sel.reshape(batch + (nb, s_max, N))
    temp = modops.mul_mod(
        x_sel, plan.bundle_inv, plan.bundle_p, plan.bundle_r0, plan.bundle_r1
    )
    lifted = modops.accumulate_mulmod_128(
        ((temp[..., :, None, i, :], plan.bundle_mat[:, :, i, None])
         for i in range(s_max)),
        plan.ext_limbs.p, plan.ext_limbs.ratio0, plan.ext_limbs.ratio1,
    )  # [..., nb, n_ext, N]
    # [0, 4p) lazy: consumed only by the inner product's exact 128-bit
    # Barrett accumulation (and value-preserving Galois permutations).
    # plan.lazy_digits gates the range: with many bundles the accumulated
    # sum would exceed 2^128 at 4p, so reduce canonically there.
    if plan.lazy_digits:
        lifted_ntt = ntt.forward_lazy(lifted, plan.ext_tables)
    else:
        lifted_ntt = ntt.forward(lifted, plan.ext_tables)
    return m_.where(plan.bundle_diag, ntt_target_ext[..., None, :, :], lifted_ntt)


def keyswitch_inner_product(ct_k, key_vector_data, plan: KeySwitchPlan,
                            is_ntt_output: bool, raw: bool = False,
                            ntt: NTTOps = IN_CORE_NTT):
    """128-bit-exact inner product of mod-up digits with a key-switch key,
    then special-prime rescale (evaluator.cpp:2313-2361).

    ct_k: [..., n_bundles, n_ext, N] NTT-domain digits;
    key_vector_data: [n_bundles, 2, L_key, N].
    Returns (delta0, delta1): [..., n_ct, N].
    """
    ext = plan.ext_limbs
    nb = plan.bundle_sel.shape[0]

    key_ext = key_vector_data[:, :, plan.ext_key_indices, :]
    out = []
    for l in range(2):
        acc = modops.accumulate_mulmod_128(
            ((ct_k[..., b, :, :], key_ext[b, l]) for b in range(nb)),
            ext.p, ext.ratio0, ext.ratio1,
        )
        if raw:
            out.append(acc)
        else:
            out.append(rescale_special(acc, plan, is_ntt_output=is_ntt_output,
                                       ntt=ntt))
    return out[0], out[1]


def batched_rotated_inner_product(ct_k, rot_tabs, keys_stack,
                                  plan: KeySwitchPlan):
    """Hoisted multi-rotation key-switch contraction: ONE gather applies
    every rotation's NTT permutation to the shared mod-up digits, then the
    128-bit inner product with each rotation's key runs as a single
    contraction over the bundle axis.  The rotation axis R stays in the
    tensor — the lazy_digits margin gate is sized for n_bundles terms, so
    R must NOT be folded into the same accumulation (callers fold the
    already-reduced per-rotation results with modular adds where a sum
    over rotations is wanted).

    This is the shared kernel behind build_{ckks,bfv}_rotate_many, the
    hoisted matvec, and poly_eval's flat rotation-sum (the per-step
    unrolled form compiles pathologically at deep L — PERF.md
    compile-time note).

    ct_k: [..., nb, n_ext, N] NTT-domain digits (one hoisted mod-up);
    rot_tabs: int[R, N] stacked Galois NTT permutation tables;
    keys_stack: u64[R, nb, 2, L_key, N].
    Returns (a0, a1): u64[..., R, n_ext, N] reduced accumulators (before
    the special-prime rescale).
    """
    m = xp(ct_k, keys_stack)
    tabs = m.asarray(rot_tabs)
    # [..., nb, n_ext, R, N] -> [..., R, nb, n_ext, N]
    rk = m.moveaxis(m.take(ct_k, tabs, axis=-1), -2, -4)
    keys_ext = keys_stack[..., plan.ext_key_indices, :]
    ext = plan.ext_limbs
    nb = plan.n_bundles
    a0 = modops.accumulate_mulmod_128(
        ((rk[..., b, :, :], keys_ext[:, b, 0]) for b in range(nb)),
        ext.p, ext.ratio0, ext.ratio1)
    a1 = modops.accumulate_mulmod_128(
        ((rk[..., b, :, :], keys_ext[:, b, 1]) for b in range(nb)),
        ext.p, ext.ratio0, ext.ratio1)
    return a0, a1


def fused_moddown(c, acc, plan: KeySwitchPlan):
    """One-pass mod-down of (P*c + acc) by Q_D = P * q_last: folds the
    ciphertext component into the raw key-switch accumulator and divides by
    the special primes AND the level's last prime together, landing at the
    next level in NTT form.

    vs the sequential path (rescale_special + add + divide_and_round_q_last
    _ntt) this saves one full NTT round trip per component; the single
    interpolation rounding differs from the two sequential roundings by a
    bounded (sub-noise) amount, so results decrypt equal but are not
    bit-identical to the sequential pipeline.

    c: [..., n_ct, N] NTT-form ciphertext component at the current level;
    acc: [..., n_ext, N] NTT-form raw inner-product accumulator.
    Returns [..., n_ct-1, N] NTT form at the next level.
    """
    k = plan.fused_drop_constants()
    n_ct = plan.n_ct_rns
    q = plan.ct_limbs

    pc = modops.mul_mod(c, k["p_mod_qi"], q.p, q.ratio0, q.ratio1)
    num_ct = modops.add_mod(acc[..., :n_ct, :], pc, q.p)
    m_ = xp(acc)
    num = m_.concatenate([num_ct, acc[..., n_ct:, :]], axis=-2)

    # D rows are contiguous: [q_last, specials]; [0, 2p) lazy into the
    # full-range Barrett mul_mod
    d_power = ntt_inverse_lazy(num[..., n_ct - 1 :, :], k["d_tables"])
    dl = k["d_limbs"]
    scaled = modops.mul_mod(d_power, k["inv_hat_d"], dl.p, dl.ratio0, dl.ratio1)
    temp = _dot_mod_128(scaled, k["neg_hat_d_qi"], k["out_limbs"])
    temp = ntt_forward(temp, k["out_tables"])

    ol = k["out_limbs"]
    s = modops.add_mod(num[..., : n_ct - 1, :], temp, ol.p)
    return modops.mul_mod(s, k["inv_qd_qi"], ol.p, ol.ratio0, ol.ratio1)


def switch_key(target, key_vector_data, plan: KeySwitchPlan, is_ntt_form: bool,
               ntt: NTTOps = IN_CORE_NTT):
    """Core hybrid key switch (evaluator.cpp:2259-2368).

    target: [..., n_ct, N] in the ciphertext domain (NTT iff is_ntt_form);
    leading batch axes broadcast.
    key_vector_data: [n_bundles, 2, L_key, N] stacked key ciphertexts
    (NTT form at the key level).
    Returns (delta0, delta1): [..., n_ct, N] contributions in the
    ciphertext domain, to be added onto c0/c1.
    """
    ct_k = compute_modup_digits(target, plan, is_ntt_form, ntt=ntt)
    return keyswitch_inner_product(ct_k, key_vector_data, plan, is_ntt_form,
                                   ntt=ntt)
