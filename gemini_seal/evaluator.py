"""Evaluator: the homomorphic operation library.

JAX rework of the reference Evaluator
(reference: native/src/seal/evaluator.{h,cpp}, 3749 LoC).  Every op is a
composition of the vectorized kernel layers (ops/dyadic, ops/ntt,
ops/rnsops, ops/keyswitch, ops/galois) over dense [size, L, N] ciphertext
tensors; scalar per-coefficient loops in the reference become fused XLA
elementwise chains, base conversions become modular matmuls, and the
ciphertext convolution in multiply is a Python-unrolled sum of dyadic
products (sizes are tiny and static).

Key-switching uses the fork's hybrid multi-special-prime algorithm
(ops/keyswitch) — with the BFV NTT-domain fix, so relinearize/rotate work
for both schemes.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from .ciphertext import Ciphertext, Plaintext
from .context import ContextData, SealContext
from .keys import GaloisKeys, KSwitchKeys, RelinKeys
from .ops import modops
from .ops.backend import set_at, xp
from .ops.dyadic import (
    add_poly,
    dyadic_product,
    multiply_poly_scalar,
    negacyclic_mono_mul_poly,
    negate_poly,
    sub_poly,
)
from .ops.keyswitch import (KeySwitchPlan, compute_modup_digits,
                            keyswitch_inner_product, switch_key)
from .ops.ntt import ntt_forward, ntt_forward_lazy, ntt_inverse
from .ops.rnsops import (
    divide_and_round_q_last,
    divide_and_round_q_last_ntt,
    fast_floor,
    fastbconv_m_tilde,
    fastbconv_sk,
    multiply_add_plain_with_scaling_variant,
    multiply_sub_plain_with_scaling_variant,
    sm_mrq,
)
from .params import PARMS_ID_ZERO, SchemeType

__all__ = ["Evaluator"]


def _same_scale(a: float, b: float) -> bool:
    """SEAL requires exactly equal scales (evaluator.h are_same_scale)."""
    return abs(a - b) < 1e-9 * max(abs(a), abs(b), 1.0)


def product_tree(layer, multiply, square, relinearize):
    """Balanced product tree (reference: evaluator.h multiply_many).

    The single source of truth for the pairing/odd-carry order — the host
    Evaluator and DeviceEvaluator both use it, which is what makes their
    multiply_many/exponentiate results bit-identical.  Identical-operand
    pairs take the dedicated square path (bit-identical to multiply)."""
    layer = list(layer)
    if not layer:
        raise ValueError("encrypteds cannot be empty")
    while len(layer) > 1:
        nxt = []
        for i in range(0, len(layer) - 1, 2):
            if layer[i] is layer[i + 1]:
                prod = square(layer[i])
            else:
                prod = multiply(layer[i], layer[i + 1])
            nxt.append(relinearize(prod))
        if len(layer) % 2:
            nxt.append(layer[-1])
        layer = nxt
    return layer[0]


class Evaluator:
    def __init__(self, context: SealContext):
        if not context.parameters_set():
            raise ValueError("encryption parameters are not set correctly")
        self.context = context
        self._ks_plans: Dict[tuple, KeySwitchPlan] = {}
        self._md_plans: Dict[tuple, object] = {}

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _cd(self, ct: Ciphertext) -> ContextData:
        cd = self.context.get_context_data(ct.parms_id)
        if cd is None:
            raise ValueError("ciphertext is not valid for encryption parameters")
        return cd

    def _scheme(self) -> SchemeType:
        return self.context.key_context_data().parms.scheme

    def _check_same(self, a: Ciphertext, b: Ciphertext):
        if a.parms_id != b.parms_id:
            raise ValueError("encrypted parameters mismatch")
        if a.is_ntt_form != b.is_ntt_form:
            raise ValueError("NTT form mismatch")
        if not _same_scale(a.scale, b.scale):
            raise ValueError("scale mismatch")

    def _ks_plan(self, parms_id) -> KeySwitchPlan:
        key = tuple(parms_id)
        plan = self._ks_plans.get(key)
        if plan is None:
            plan = KeySwitchPlan(self.context, parms_id)
            self._ks_plans[key] = plan
        return plan

    def _plain_to_full(self, plain: Plaintext, n: int) -> np.ndarray:
        m = np.zeros(n, dtype=np.uint64)
        pdata = np.asarray(plain.data)
        m[: pdata.shape[0]] = pdata
        return m

    # ------------------------------------------------------------------
    # linear ops
    # ------------------------------------------------------------------
    def negate(self, encrypted: Ciphertext) -> Ciphertext:
        cd = self._cd(encrypted)
        return Ciphertext(
            negate_poly(encrypted.data, cd.limb_constants),
            encrypted.parms_id,
            encrypted.is_ntt_form,
            encrypted.scale,
        )

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        self._check_same(a, b)
        cd = self._cd(a)
        limbs = cd.limb_constants
        if a.size == b.size:
            data = add_poly(a.data, b.data, limbs)
        else:
            big, small = (a, b) if a.size > b.size else (b, a)
            data = set_at(
                big.data, slice(None, small.size),
                add_poly(big.data[: small.size], small.data, limbs),
            )
        return Ciphertext(data, a.parms_id, a.is_ntt_form, a.scale)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        self._check_same(a, b)
        cd = self._cd(a)
        limbs = cd.limb_constants
        min_sz = min(a.size, b.size)
        head = sub_poly(a.data[:min_sz], b.data[:min_sz], cd.limb_constants)
        if a.size == b.size:
            data = head
        elif a.size > b.size:
            data = set_at(a.data, slice(None, min_sz), head)
        else:
            tail = negate_poly(b.data[min_sz:], limbs)
            data = xp(a.data).concatenate([head, tail], axis=0)
        return Ciphertext(data, a.parms_id, a.is_ntt_form, a.scale)

    def add_many(self, encrypteds: Sequence[Ciphertext]) -> Ciphertext:
        if not encrypteds:
            raise ValueError("encrypteds cannot be empty")
        acc = encrypteds[0]
        for ct in encrypteds[1:]:
            acc = self.add(acc, ct)
        return acc

    # ------------------------------------------------------------------
    # plaintext ops
    # ------------------------------------------------------------------
    def add_plain(self, encrypted: Ciphertext, plain: Plaintext) -> Ciphertext:
        cd = self._cd(encrypted)
        scheme = cd.parms.scheme
        if scheme == SchemeType.BFV:
            if encrypted.is_ntt_form or plain.is_ntt_form:
                raise ValueError("BFV add_plain operands cannot be in NTT form")
            m = self._plain_to_full(plain, cd.parms.poly_modulus_degree)
            c0 = multiply_add_plain_with_scaling_variant(
                encrypted.data[0], m, cd
            )
            data = set_at(encrypted.data, 0, c0)
            return Ciphertext(data, encrypted.parms_id, False, encrypted.scale)
        # CKKS
        if not encrypted.is_ntt_form or not plain.is_ntt_form:
            raise ValueError("CKKS add_plain operands must be in NTT form")
        if encrypted.parms_id != plain.parms_id:
            raise ValueError("encrypted and plain parameter mismatch")
        if not _same_scale(encrypted.scale, plain.scale):
            raise ValueError("scale mismatch")
        c0 = add_poly(encrypted.data[0], np.asarray(plain.data), cd.limb_constants)
        return Ciphertext(
            set_at(encrypted.data, 0, c0), encrypted.parms_id, True, encrypted.scale
        )

    def sub_plain(self, encrypted: Ciphertext, plain: Plaintext) -> Ciphertext:
        cd = self._cd(encrypted)
        scheme = cd.parms.scheme
        if scheme == SchemeType.BFV:
            if encrypted.is_ntt_form or plain.is_ntt_form:
                raise ValueError("BFV sub_plain operands cannot be in NTT form")
            m = self._plain_to_full(plain, cd.parms.poly_modulus_degree)
            c0 = multiply_sub_plain_with_scaling_variant(
                encrypted.data[0], m, cd
            )
            return Ciphertext(
                set_at(encrypted.data, 0, c0), encrypted.parms_id, False, encrypted.scale
            )
        if not encrypted.is_ntt_form or not plain.is_ntt_form:
            raise ValueError("CKKS sub_plain operands must be in NTT form")
        if encrypted.parms_id != plain.parms_id:
            raise ValueError("encrypted and plain parameter mismatch")
        if not _same_scale(encrypted.scale, plain.scale):
            raise ValueError("scale mismatch")
        c0 = sub_poly(encrypted.data[0], np.asarray(plain.data), cd.limb_constants)
        return Ciphertext(
            set_at(encrypted.data, 0, c0), encrypted.parms_id, True, encrypted.scale
        )

    def multiply_plain(self, encrypted: Ciphertext, plain: Plaintext) -> Ciphertext:
        if encrypted.is_ntt_form and plain.is_ntt_form:
            return self._multiply_plain_ntt(encrypted, plain)
        if not encrypted.is_ntt_form and not plain.is_ntt_form:
            return self._multiply_plain_normal(encrypted, plain)
        raise ValueError("NTT form mismatch")

    def _multiply_plain_ntt(self, encrypted: Ciphertext, plain: Plaintext) -> Ciphertext:
        if encrypted.parms_id != plain.parms_id:
            raise ValueError("encrypted_ntt and plain_ntt parameter mismatch")
        cd = self._cd(encrypted)
        new_scale = encrypted.scale * plain.scale
        self._check_scale_bounds(new_scale, cd)
        data = dyadic_product(
            encrypted.data, np.asarray(plain.data), cd.limb_constants
        )
        return Ciphertext(data, encrypted.parms_id, True, new_scale)

    def _multiply_plain_normal(self, encrypted: Ciphertext, plain: Plaintext) -> Ciphertext:
        """reference: evaluator.cpp:1475-1602 (generic path; the monomial
        fast path uses a negacyclic shift)."""
        cd = self._cd(encrypted)
        parms = cd.parms
        n = parms.poly_modulus_degree
        L = len(parms.coeff_modulus)
        limbs = cd.limb_constants
        thresh = cd.plain_upper_half_threshold
        new_scale = encrypted.scale * plain.scale
        self._check_scale_bounds(new_scale, cd)

        pdata = np.asarray(plain.data, dtype=np.uint64)
        nonzero = np.nonzero(pdata)[0]
        if nonzero.size == 1:
            # monomial fast path (evaluator.cpp:1514-1551)
            e = int(nonzero[0])
            c = int(pdata[e])
            if c >= thresh:
                if not cd.qualifiers.using_fast_plain_lift:
                    lifted = cd.rns_base.decompose(
                        c + (cd.total_coeff_modulus - parms.plain_modulus.value)
                    )
                    mono = np.array(lifted, dtype=np.uint64).reshape(-1, 1)
                else:
                    mono = (cd.plain_upper_half_increment + np.uint64(c)).reshape(-1, 1)
            else:
                mono = np.uint64(c)
            data = negacyclic_mono_mul_poly(encrypted.data, mono, e, limbs)
            return Ciphertext(data, encrypted.parms_id, False, new_scale)

        # generic path: lift plain to RNS, NTT, dyadic per component
        m = np.zeros(n, dtype=np.uint64)
        m[: pdata.shape[0]] = pdata
        if not cd.qualifiers.using_fast_plain_lift:
            # add q - t to upper-half coefficients, then CRT-decompose
            t = parms.plain_modulus.value
            qmt = cd.total_coeff_modulus - t
            vals = [int(v) + qmt if int(v) >= thresh else int(v) for v in m]
            temp = cd.rns_base.decompose_array(vals)      # [L, N]
        else:
            inc = cd.plain_upper_half_increment.reshape(-1, 1)   # [L,1]
            temp = np.where(m >= thresh, m + inc, np.broadcast_to(m, (L, n)))
        temp = ntt_forward(np.asarray(temp, dtype=np.uint64), cd.ntt_tables)
        ct_ntt = ntt_forward(encrypted.data, cd.ntt_tables)
        prod = dyadic_product(ct_ntt, temp, limbs)
        data = ntt_inverse(prod, cd.ntt_tables)
        return Ciphertext(data, encrypted.parms_id, False, new_scale)

    # ------------------------------------------------------------------
    # multiplication
    # ------------------------------------------------------------------
    def multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        if a.parms_id != b.parms_id:
            raise ValueError("encrypted parameters mismatch")
        scheme = self._cd(a).parms.scheme
        if scheme == SchemeType.BFV:
            out = self._bfv_multiply(a, b)
        elif scheme == SchemeType.CKKS:
            out = self._ckks_multiply(a, b)
        else:
            raise ValueError("unsupported scheme")
        if out.is_transparent():
            raise RuntimeError("result ciphertext is transparent")
        return out

    def square(self, encrypted: Ciphertext) -> Ciphertext:
        """Dedicated square path (reference: evaluator.cpp:560-770
        bfv_square/ckks_square): for size-2 ciphertexts the BEHZ base
        extension + NTT lift runs ONCE (multiply runs it per operand) and
        the 4-product convolution collapses to 3 products (c0^2, 2*c0*c1,
        c1^2).  Bit-identical to multiply(x, x) — the reference's 2*c0*c1
        equals its c0*c1 + c1*c0 exactly."""
        if encrypted.size != 2:
            return self.multiply(encrypted, encrypted)
        scheme = self._cd(encrypted).parms.scheme
        if scheme == SchemeType.BFV:
            out = self._bfv_square(encrypted)
        elif scheme == SchemeType.CKKS:
            out = self._ckks_square(encrypted)
        else:
            raise ValueError("unsupported scheme")
        if out.is_transparent():
            raise RuntimeError("result ciphertext is transparent")
        return out

    def _square_convolve(self, polys: List, limbs) -> List:
        """Size-2 square convolution: [c0^2, 2*c0*c1, c1^2]
        (evaluator.cpp:659-676 behz_ciphertext_square)."""
        a0, a1 = polys
        cross = dyadic_product(a0, a1, limbs)
        return [
            dyadic_product(a0, a0, limbs),
            add_poly(cross, cross, limbs),
            dyadic_product(a1, a1, limbs),
        ]

    def _bfv_square(self, encrypted: Ciphertext) -> Ciphertext:
        """BEHZ RNS squaring, one base extension (evaluator.cpp:560-706)."""
        if encrypted.is_ntt_form:
            raise ValueError("BFV square operand cannot be in NTT form")
        cd = self._cd(encrypted)
        parms = cd.parms
        tool = cd.device_rns_tool
        limbs = cd.limb_constants
        bsk_limbs = tool.Bsk_limbs
        t = np.uint64(parms.plain_modulus.value)

        # steps (1)-(3) ONCE: lift to q U Bsk, NTT both (lazy [0, 4p) into
        # the convolution's Barrett products — bit-identical, see extend)
        q_ntt = ntt_forward_lazy(encrypted.data, cd.ntt_tables)
        lifted = fastbconv_m_tilde(encrypted.data, tool)
        bsk = sm_mrq(lifted, tool)
        bsk_ntt = ntt_forward_lazy(bsk, tool.base_Bsk_ntt_tables)

        # step (4): 3-product square convolution in both bases
        dest_q = self._square_convolve(list(q_ntt), limbs)
        dest_bsk = self._square_convolve(list(bsk_ntt), bsk_limbs)

        # steps (5)-(8), as in _bfv_multiply
        out_polys = []
        for dq, dbsk in zip(dest_q, dest_bsk):
            dq = ntt_inverse(dq, cd.ntt_tables)
            dbsk = ntt_inverse(dbsk, tool.base_Bsk_ntt_tables)
            tq = multiply_poly_scalar(dq, t, limbs)
            tbsk = modops.mul_mod(dbsk, t, bsk_limbs.p, bsk_limbs.ratio0, bsk_limbs.ratio1)
            floored = fast_floor(tq, tbsk, tool)
            out_polys.append(fastbconv_sk(floored, tool))
        return Ciphertext(
            xp(*out_polys).stack(out_polys), encrypted.parms_id, False, encrypted.scale
        )

    def _ckks_square(self, encrypted: Ciphertext) -> Ciphertext:
        """reference: evaluator.cpp:708-770."""
        if not encrypted.is_ntt_form:
            raise ValueError("CKKS square operand must be in NTT form")
        cd = self._cd(encrypted)
        new_scale = encrypted.scale * encrypted.scale
        self._check_scale_bounds(new_scale, cd)
        dest = self._square_convolve(list(encrypted.data), cd.limb_constants)
        return Ciphertext(xp(*dest).stack(dest), encrypted.parms_id, True, new_scale)

    def _convolve(self, a_polys: List, b_polys: List, limbs) -> List:
        """dest[k] = sum_{i+j=k} a_i ⊙ b_j (evaluator.cpp:376-420)."""
        sa, sb = len(a_polys), len(b_polys)
        dest = []
        for k in range(sa + sb - 1):
            acc = None
            for i in range(max(0, k - sb + 1), min(k, sa - 1) + 1):
                term = dyadic_product(a_polys[i], b_polys[k - i], limbs)
                acc = term if acc is None else add_poly(acc, term, limbs)
            dest.append(acc)
        return dest

    def _bfv_multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """BEHZ RNS multiplication (reference: evaluator.cpp:274-445)."""
        if a.is_ntt_form or b.is_ntt_form:
            raise ValueError("BFV multiply operands cannot be in NTT form")
        cd = self._cd(a)
        parms = cd.parms
        tool = cd.device_rns_tool
        limbs = cd.limb_constants
        bsk_limbs = tool.Bsk_limbs
        t = np.uint64(parms.plain_modulus.value)

        def extend(ct: Ciphertext):
            # steps (1)-(3): lift to q U Bsk, NTT both.  Lazy [0, 4p)
            # outputs (ntt_negacyclic_harvey_lazy dataflow, evaluator.cpp
            # behz_extend_base_convert_to_ntt): the only consumers are the
            # convolution's full-range Barrett dyadic products, so results
            # are bit-identical to the canonical path.
            q_ntt = ntt_forward_lazy(ct.data, cd.ntt_tables)
            lifted = fastbconv_m_tilde(ct.data, tool)
            bsk = sm_mrq(lifted, tool)
            bsk_ntt = ntt_forward_lazy(bsk, tool.base_Bsk_ntt_tables)
            return list(q_ntt), list(bsk_ntt)

        a_q, a_bsk = extend(a)
        b_q, b_bsk = extend(b)

        # step (4): dyadic convolution in both bases
        dest_q = self._convolve(a_q, b_q, limbs)
        dest_bsk = self._convolve(a_bsk, b_bsk, bsk_limbs)

        # steps (5)-(8)
        out_polys = []
        for dq, dbsk in zip(dest_q, dest_bsk):
            dq = ntt_inverse(dq, cd.ntt_tables)
            dbsk = ntt_inverse(dbsk, tool.base_Bsk_ntt_tables)
            tq = multiply_poly_scalar(dq, t, limbs)
            tbsk = modops.mul_mod(dbsk, t, bsk_limbs.p, bsk_limbs.ratio0, bsk_limbs.ratio1)
            floored = fast_floor(tq, tbsk, tool)
            out_polys.append(fastbconv_sk(floored, tool))
        return Ciphertext(
            xp(*out_polys).stack(out_polys), a.parms_id, False, a.scale
        )

    def _ckks_multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """reference: evaluator.cpp:447-527."""
        if not (a.is_ntt_form and b.is_ntt_form):
            raise ValueError("CKKS multiply operands must be in NTT form")
        cd = self._cd(a)
        new_scale = a.scale * b.scale
        self._check_scale_bounds(new_scale, cd)
        limbs = cd.limb_constants
        dest = self._convolve(list(a.data), list(b.data), limbs)
        return Ciphertext(xp(*dest).stack(dest), a.parms_id, True, new_scale)

    def _check_scale_bounds(self, scale: float, cd: ContextData):
        if scale <= 0 or int(math.log2(scale)) >= cd.total_coeff_modulus_bit_count:
            raise ValueError("scale out of bounds")

    # ------------------------------------------------------------------
    # relinearization / key switching
    # ------------------------------------------------------------------
    def relinearize(self, encrypted: Ciphertext, relin_keys: RelinKeys) -> Ciphertext:
        return self._relinearize_internal(encrypted, relin_keys, 2)

    def _relinearize_internal(
        self, encrypted: Ciphertext, relin_keys: RelinKeys, destination_size: int
    ) -> Ciphertext:
        """reference: evaluator.cpp:772-827."""
        if relin_keys.parms_id != self.context.key_parms_id:
            raise ValueError("relin_keys is not valid for encryption parameters")
        sz = encrypted.size
        if destination_size < 2 or destination_size > sz:
            raise ValueError("destination_size out of range")
        if relin_keys.size() < sz - 2:
            raise ValueError("not enough relinearization keys")
        if destination_size == sz:
            return encrypted
        cd = self._cd(encrypted)
        limbs = cd.limb_constants
        plan = self._ks_plan(encrypted.parms_id)
        data = encrypted.data
        # Remove components sz-1 .. destination_size, highest first; removing
        # component `power` (the s^power term) uses the keys for s^power and
        # folds the result into (c0, c1).
        for power in range(sz - 1, destination_size - 1, -1):
            target = data[power]
            key_vec = relin_keys.key(power)
            kdata = np.stack([np.asarray(pk.data.data) for pk in key_vec])
            d0, d1 = switch_key(target, kdata, plan, encrypted.is_ntt_form)
            c0 = add_poly(data[0], d0, limbs)
            c1 = add_poly(data[1], d1, limbs)
            head = data[:power]
            if isinstance(head, np.ndarray):
                head = head.copy()
                head[0] = c0
                head[1] = c1
                data = head
            else:
                data = head.at[0].set(c0).at[1].set(c1)
        out = Ciphertext(
            data,
            encrypted.parms_id,
            encrypted.is_ntt_form,
            encrypted.scale,
        )
        if out.is_transparent():
            raise RuntimeError("result ciphertext is transparent")
        return out

    def apply_galois(
        self, encrypted: Ciphertext, galois_elt: int, galois_keys: GaloisKeys
    ) -> Ciphertext:
        """reference: evaluator.cpp:1841-1943."""
        if galois_keys.parms_id != self.context.key_parms_id:
            raise ValueError("galois_keys is not valid for encryption parameters")
        cd = self._cd(encrypted)
        if encrypted.size > 2:
            raise ValueError("encrypted size must be 2")
        tool = cd.galois_tool
        limbs = cd.limb_constants
        if not galois_keys.has_key(galois_elt):
            raise ValueError("Galois key not present")

        if not encrypted.is_ntt_form:
            c0 = tool.apply_galois(encrypted.data[0], galois_elt, limbs)
            c1 = tool.apply_galois(encrypted.data[1], galois_elt, limbs)
        else:
            c0 = tool.apply_galois_ntt(encrypted.data[0], galois_elt)
            c1 = tool.apply_galois_ntt(encrypted.data[1], galois_elt)

        plan = self._ks_plan(encrypted.parms_id)
        key_vec = galois_keys.key(galois_elt)
        kdata = np.stack([np.asarray(pk.data.data) for pk in key_vec])
        d0, d1 = switch_key(c1, kdata, plan, encrypted.is_ntt_form)
        new_c0 = add_poly(c0, d0, limbs)
        new_c1 = d1
        data = xp(new_c0, new_c1).stack([new_c0, new_c1])
        return Ciphertext(data, encrypted.parms_id, encrypted.is_ntt_form, encrypted.scale)

    def _rotate_internal(
        self, encrypted: Ciphertext, steps: int, galois_keys: GaloisKeys
    ) -> Ciphertext:
        """reference: evaluator.cpp:1945-2000 (direct key or NAF fallback)."""
        cd = self._cd(encrypted)
        if not cd.qualifiers.using_batching:
            raise RuntimeError("encryption parameters do not support batching")
        if galois_keys.parms_id != self.context.key_parms_id:
            raise ValueError("galois_keys is not valid for encryption parameters")
        if steps == 0:
            return encrypted
        tool = cd.galois_tool
        elt = tool.get_elt_from_step(steps)
        if galois_keys.has_key(elt):
            return self.apply_galois(encrypted, elt, galois_keys)
        # NAF decomposition fallback (evaluator.cpp:1977-1999). A single-term
        # NAF means a power-of-two rotation whose key is simply absent —
        # recursing would loop forever, so mirror the reference's throw.
        from .utils.numth import naf

        terms = naf(steps)
        if len(terms) == 1:
            raise ValueError("Galois key not present")
        out = encrypted
        for term in sorted(terms, key=abs, reverse=True):
            if abs(term) != (cd.parms.poly_modulus_degree >> 1):
                out = self._rotate_internal(out, term, galois_keys)
        return out

    # BFV batching rotations (evaluator.h:1057-1167)
    def rotate_rows(self, encrypted: Ciphertext, steps: int, galois_keys: GaloisKeys) -> Ciphertext:
        if self._scheme() != SchemeType.BFV:
            raise ValueError("unsupported scheme")
        return self._rotate_internal(encrypted, steps, galois_keys)

    def rotate_columns(self, encrypted: Ciphertext, galois_keys: GaloisKeys) -> Ciphertext:
        if self._scheme() != SchemeType.BFV:
            raise ValueError("unsupported scheme")
        n = self._cd(encrypted).parms.poly_modulus_degree
        return self.apply_galois(encrypted, 2 * n - 1, galois_keys)

    # CKKS rotations (evaluator.h:1201-1307)
    def rotate_vector(self, encrypted: Ciphertext, steps: int, galois_keys: GaloisKeys) -> Ciphertext:
        if self._scheme() != SchemeType.CKKS:
            raise ValueError("unsupported scheme")
        return self._rotate_internal(encrypted, steps, galois_keys)

    def complex_conjugate(self, encrypted: Ciphertext, galois_keys: GaloisKeys) -> Ciphertext:
        if self._scheme() != SchemeType.CKKS:
            raise ValueError("unsupported scheme")
        n = self._cd(encrypted).parms.poly_modulus_degree
        return self.apply_galois(encrypted, 2 * n - 1, galois_keys)

    # Hoisted multi-rotation (no analogue in the reference; standard
    # hoisting optimization: the mod-up digit decomposition of c1 is computed
    # ONCE and reused for every Galois element — the automorphism commutes
    # with the per-coefficient CRT lift up to Q_bundle multiples, which the
    # key-switch absorbs as bounded extra noise).
    def apply_galois_many(
        self,
        encrypted: Ciphertext,
        galois_elts: Sequence[int],
        galois_keys: GaloisKeys,
    ) -> List[Ciphertext]:
        if galois_keys.parms_id != self.context.key_parms_id:
            raise ValueError("galois_keys is not valid for encryption parameters")
        cd = self._cd(encrypted)
        if encrypted.size > 2:
            raise ValueError("encrypted size must be 2")
        tool = cd.galois_tool
        limbs = cd.limb_constants
        for elt in galois_elts:
            if not galois_keys.has_key(elt):
                raise ValueError("Galois key not present")
        plan = self._ks_plan(encrypted.parms_id)
        is_ntt = encrypted.is_ntt_form
        c0, c1 = encrypted.data[0], encrypted.data[1]
        ct_k = compute_modup_digits(c1, plan, is_ntt)   # hoisted (once)

        outs = []
        for elt in galois_elts:
            ct_k_rot = tool.apply_galois_ntt(ct_k, elt)
            key_vec = galois_keys.key(elt)
            kdata = np.stack([np.asarray(pk.data.data) for pk in key_vec])
            d0, d1 = keyswitch_inner_product(ct_k_rot, kdata, plan, is_ntt)
            if is_ntt:
                p0 = tool.apply_galois_ntt(c0, elt)
            else:
                p0 = tool.apply_galois(c0, elt, limbs)
            new_c0 = add_poly(p0, d0, limbs)
            data = xp(new_c0, d1).stack([new_c0, d1])
            outs.append(
                Ciphertext(data, encrypted.parms_id, is_ntt, encrypted.scale)
            )
        return outs

    def rotate_vector_many(
        self,
        encrypted: Ciphertext,
        steps: Sequence[int],
        galois_keys: GaloisKeys,
    ) -> List[Ciphertext]:
        """k CKKS rotations for one mod-up (hoisting): ~(modup + NTT) saved
        per extra rotation; every step must have a direct key."""
        if self._scheme() != SchemeType.CKKS:
            raise ValueError("unsupported scheme")
        tool = self._cd(encrypted).galois_tool
        elts = tool.get_elts_from_steps(list(steps))
        return self.apply_galois_many(encrypted, elts, galois_keys)

    def rotate_rows_many(
        self,
        encrypted: Ciphertext,
        steps: Sequence[int],
        galois_keys: GaloisKeys,
    ) -> List[Ciphertext]:
        """k BFV row rotations for one mod-up (hoisting)."""
        if self._scheme() != SchemeType.BFV:
            raise ValueError("unsupported scheme")
        tool = self._cd(encrypted).galois_tool
        elts = tool.get_elts_from_steps(list(steps))
        return self.apply_galois_many(encrypted, elts, galois_keys)

    # ------------------------------------------------------------------
    # modulus switching / rescaling
    # ------------------------------------------------------------------
    def _mod_switch_scale_to_next(self, encrypted: Ciphertext) -> Ciphertext:
        """reference: evaluator.cpp:829-892."""
        cd = self._cd(encrypted)
        scheme = cd.parms.scheme
        if scheme == SchemeType.BFV and encrypted.is_ntt_form:
            raise ValueError("BFV encrypted cannot be in NTT form")
        if scheme == SchemeType.CKKS and not encrypted.is_ntt_form:
            raise ValueError("CKKS encrypted must be in NTT form")
        next_cd = cd.next_context_data
        if next_cd is None:
            raise ValueError("end of modulus switching chain reached")
        tool = cd.device_rns_tool
        if scheme == SchemeType.BFV:
            data = divide_and_round_q_last(encrypted.data, tool)
        else:
            data = divide_and_round_q_last_ntt(encrypted.data, tool, cd.ntt_tables)
        new_scale = encrypted.scale
        if scheme == SchemeType.CKKS:
            new_scale = encrypted.scale / cd.parms.coeff_modulus[-1].value
        return Ciphertext(data, next_cd.parms_id, encrypted.is_ntt_form, new_scale)

    def _mod_switch_drop_to_next(self, encrypted: Ciphertext) -> Ciphertext:
        """reference: evaluator.cpp:894-994."""
        cd = self._cd(encrypted)
        next_cd = cd.next_context_data
        if next_cd is None:
            raise ValueError("end of modulus switching chain reached")
        next_L = len(next_cd.parms.coeff_modulus)
        self._check_scale_bounds(encrypted.scale, next_cd)
        return Ciphertext(
            encrypted.data[:, :next_L, :],
            next_cd.parms_id,
            encrypted.is_ntt_form,
            encrypted.scale,
        )

    def mod_switch_to_next(self, encrypted: Ciphertext) -> Ciphertext:
        scheme = self._scheme()
        if scheme == SchemeType.BFV:
            return self._mod_switch_scale_to_next(encrypted)
        return self._mod_switch_drop_to_next(encrypted)

    def mod_switch_to(self, encrypted: Ciphertext, parms_id,
                      fused: bool = False) -> Ciphertext:
        cd = self._cd(encrypted)
        target = self.context.get_context_data(parms_id)
        if target is None:
            raise ValueError("parms_id is not valid")
        if cd.chain_index < target.chain_index:
            raise ValueError("cannot switch to higher level modulus")
        levels = cd.chain_index - target.chain_index
        if (fused and levels >= 2 and cd.parms.scheme == SchemeType.BFV
                and not encrypted.is_ntt_form):
            # one rounded division by the product of the dropped primes
            # instead of a per-level chain (decrypts identically; bounded
            # sub-noise rounding difference — see rnsops.MultiDropPlan)
            from .ops.rnsops import divide_and_round_multi

            plan = self._multi_drop_plan(encrypted.parms_id, levels)
            data = divide_and_round_multi(encrypted.data, plan)
            return Ciphertext(data, tuple(parms_id), False, encrypted.scale)
        out = encrypted
        while out.parms_id != tuple(parms_id):
            out = self.mod_switch_to_next(out)
        return out

    def _multi_drop_plan(self, parms_id, levels: int):
        from .ops.rnsops import MultiDropPlan

        key = (tuple(parms_id), levels)
        plan = self._md_plans.get(key)
        if plan is None:
            plan = MultiDropPlan(self.context, parms_id, levels)
            self._md_plans[key] = plan
        return plan

    def mod_switch_plain_to_next(self, plain: Plaintext) -> Plaintext:
        """NTT-form plaintext modulus drop (evaluator.cpp:966-994)."""
        if not plain.is_ntt_form:
            raise ValueError("plain is not in NTT form")
        cd = self.context.get_context_data(plain.parms_id)
        next_cd = cd.next_context_data
        if next_cd is None:
            raise ValueError("end of modulus switching chain reached")
        next_L = len(next_cd.parms.coeff_modulus)
        return Plaintext(
            data=np.asarray(plain.data)[:next_L, :],
            parms_id=next_cd.parms_id,
            scale=plain.scale,
        )

    def mod_switch_plain_to(self, plain: Plaintext, parms_id) -> Plaintext:
        out = plain
        while out.parms_id != tuple(parms_id):
            out = self.mod_switch_plain_to_next(out)
        return out

    def rescale_to_next(self, encrypted: Ciphertext) -> Ciphertext:
        if self._scheme() != SchemeType.CKKS:
            raise ValueError("unsupported scheme")
        return self._mod_switch_scale_to_next(encrypted)

    def rescale_to(self, encrypted: Ciphertext, parms_id) -> Ciphertext:
        target = self.context.get_context_data(parms_id)
        cd = self._cd(encrypted)
        if target is None or cd.chain_index < target.chain_index:
            raise ValueError("cannot switch to higher level modulus")
        out = encrypted
        while out.parms_id != tuple(parms_id):
            out = self.rescale_to_next(out)
        return out

    # ------------------------------------------------------------------
    # NTT transforms
    # ------------------------------------------------------------------
    def transform_to_ntt(self, encrypted: Ciphertext) -> Ciphertext:
        if encrypted.is_ntt_form:
            raise ValueError("encrypted is already in NTT form")
        cd = self._cd(encrypted)
        return Ciphertext(
            ntt_forward(encrypted.data, cd.ntt_tables),
            encrypted.parms_id,
            True,
            encrypted.scale,
        )

    def transform_from_ntt(self, encrypted: Ciphertext) -> Ciphertext:
        if not encrypted.is_ntt_form:
            raise ValueError("encrypted is not in NTT form")
        cd = self._cd(encrypted)
        return Ciphertext(
            ntt_inverse(encrypted.data, cd.ntt_tables),
            encrypted.parms_id,
            False,
            encrypted.scale,
        )

    def transform_plain_to_ntt(self, plain: Plaintext, parms_id) -> Plaintext:
        """Lift a BFV plaintext into NTT form at a level
        (reference: evaluator.cpp:1648-1718)."""
        if plain.is_ntt_form:
            raise ValueError("plain is already in NTT form")
        cd = self.context.get_context_data(parms_id)
        parms = cd.parms
        n = parms.poly_modulus_degree
        L = len(parms.coeff_modulus)
        thresh = cd.plain_upper_half_threshold
        m = self._plain_to_full(plain, n)
        if not cd.qualifiers.using_fast_plain_lift:
            t = parms.plain_modulus.value
            qmt = cd.total_coeff_modulus - t
            vals = [int(v) + qmt if int(v) >= thresh else int(v) for v in m]
            temp = cd.rns_base.decompose_array(vals)
        else:
            inc = cd.plain_upper_half_increment.reshape(-1, 1)
            temp = np.where(m >= thresh, m + inc, np.broadcast_to(m, (L, n)))
        data = ntt_forward(np.asarray(temp, dtype=np.uint64), cd.ntt_tables)
        return Plaintext(data=np.asarray(data), parms_id=cd.parms_id, scale=plain.scale)

    # ------------------------------------------------------------------
    # composite ops
    # ------------------------------------------------------------------
    def multiply_many(
        self, encrypteds: Sequence[Ciphertext], relin_keys: RelinKeys
    ) -> Ciphertext:
        """Balanced product tree with relinearization
        (reference: evaluator.h multiply_many)."""
        if self._scheme() != SchemeType.BFV:
            raise ValueError("unsupported scheme")
        return product_tree(
            encrypteds, self.multiply, self.square,
            lambda ct: self.relinearize(ct, relin_keys),
        )

    def exponentiate(
        self, encrypted: Ciphertext, exponent: int, relin_keys: RelinKeys
    ) -> Ciphertext:
        if exponent == 0:
            raise ValueError("exponent cannot be 0")
        if exponent == 1:
            return encrypted
        return self.multiply_many([encrypted] * exponent, relin_keys)
