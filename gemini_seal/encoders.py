"""Encoders: BFV SIMD batching, CKKS canonical embedding, legacy integer.

JAX rework of the reference encoders
(reference: native/src/seal/batchencoder.{h,cpp}, ckks.{h,cpp},
intencoder.{h,cpp}, util/croots.{h,cpp}).

BatchEncoder: the 2x(N/2) matrix index map via generator 3 + the mod-t
negacyclic NTT.  CKKSEncoder: the canonical embedding C^{N/2} -> R with the
generator-5 slot map and the high-precision 2N-th complex roots (8-fold
symmetry); the embedding FFT runs vectorized on host in float64 — encode
is a host boundary, not a hot path.  Rounding semantics (round half away
from zero, the three coefficient-size regimes) match the reference exactly.
"""

from __future__ import annotations

import cmath
import math
from typing import List, Sequence, Union

import numpy as np

from .ciphertext import Plaintext
from .context import SealContext
from .ops import modops
from .ops.ntt import ntt_forward, ntt_inverse
from .params import SchemeType
from .utils import mplimb, numth

__all__ = ["BatchEncoder", "CKKSEncoder", "IntegerEncoder", "ComplexRoots"]


class ComplexRoots:
    """High-precision 2N-th complex roots with 8-fold symmetry
    (reference: util/croots.cpp)."""

    PI = 3.1415926535897932384626433832795028842

    def __init__(self, degree_of_roots: int):
        self.degree = degree_of_roots
        # 1/8 of the circle, exactly as the reference generates them.
        self._roots = [
            cmath.rect(1.0, 2 * self.PI * i / degree_of_roots)
            for i in range(degree_of_roots // 8 + 1)
        ]

    def get_root(self, index: int) -> complex:
        index &= self.degree - 1
        d = self.degree
        if index <= d // 8:
            return self._roots[index]
        if index <= d // 4:
            r = self._roots[d // 4 - index]
            return complex(r.imag, r.real)
        if index <= d // 2:
            return -self.get_root(d // 2 - index).conjugate()
        if index <= 3 * d // 4:
            return -self.get_root(index - d // 2)
        return self.get_root(d - index).conjugate()


class BatchEncoder:
    """BFV SIMD slots (reference: batchencoder.cpp).

    compat_gen3=True reproduces the reference's generator-3 index map
    (batchencoder.cpp:77-91) so slot ORDER interoperates with plaintexts
    batch-encoded by the reference; rotations on such data must then use
    generator-3 Galois elements (GaloisTool.get_elt_from_step(...,
    generator=3)) to act as row rotations.  The default generator-5 map
    matches the fork's GaloisTool (galois.h:169) so the standard
    rotate_rows/rotate_columns keys permute slots correctly (README
    deviation #2)."""

    def __init__(self, context: SealContext, compat_gen3: bool = False):
        if not context.parameters_set():
            raise ValueError("encryption parameters are not set correctly")
        cd = context.first_context_data()
        if cd.parms.scheme != SchemeType.BFV:
            raise ValueError("unsupported scheme")
        if not cd.qualifiers.using_batching:
            raise ValueError("encryption parameters are not valid for batching")
        self.context = context
        self.slots = cd.parms.poly_modulus_degree
        self.generator = 3 if compat_gen3 else 5
        self._index_map = self._populate_index_map()

    @property
    def slot_count(self) -> int:
        return self.slots

    def _populate_index_map(self) -> np.ndarray:
        """2x(N/2) matrix map, bit-reversed (batchencoder.cpp:69-91).

        Deviation: the reference builds this map with generator 3 while the
        fork's GaloisTool rotates with generator 5 (galois.h:169) — which,
        combined with the fork's BFV key-switch bug, leaves BFV batching
        rotations broken in the reference.  We use generator 5 by default so
        rotate_rows/rotate_columns permute slots correctly; compat_gen3
        gives the reference-interoperable order."""
        n = self.slots
        logn = numth.get_power_of_two(n)
        row_size = n >> 1
        m = n << 1
        gen, pos = self.generator, 1
        index_map = np.zeros(n, dtype=np.int64)
        for i in range(row_size):
            index1 = (pos - 1) >> 1
            index2 = (m - pos - 1) >> 1
            index_map[i] = numth.reverse_bits(index1, logn)
            index_map[row_size | i] = numth.reverse_bits(index2, logn)
            pos = (pos * gen) & (m - 1)
        return index_map

    def encode(self, values: Sequence[int]) -> Plaintext:
        """uint64/int64 slot values -> plaintext poly
        (batchencoder.cpp:115-198)."""
        cd = self.context.first_context_data()
        t = cd.parms.plain_modulus.value
        if len(values) > self.slots:
            raise ValueError("values_matrix size is too large")
        try:
            vals = np.asarray(list(values), dtype=np.int64)
        except OverflowError:
            raise ValueError("input value is larger than plain_modulus")
        if vals.size and (int(vals.min()) < -t or int(vals.max()) >= t):
            raise ValueError("input value is larger than plain_modulus")
        vals = np.where(vals < 0, vals + t, vals).astype(np.uint64)
        dest = np.zeros(self.slots, dtype=np.uint64)
        dest[self._index_map[: vals.size]] = vals
        out = ntt_inverse(
            np.asarray(dest[None, :]), cd.plain_ntt_tables
        )
        return Plaintext(data=np.asarray(out[0], dtype=np.uint64))

    def encode_batch(self, values_list) -> List[Plaintext]:
        """Encode MANY slot-value vectors with ONE inverse-NTT pass over
        the [B, N] stack (serving ingestion; identical Plaintexts to
        per-vector encode)."""
        cd = self.context.first_context_data()
        t = cd.parms.plain_modulus.value
        rows = []
        for values in values_list:
            vals = np.asarray(list(values), dtype=np.int64)
            if vals.size > self.slots:
                raise ValueError("values_matrix size is too large")
            if vals.size and (int(vals.min()) < -t or int(vals.max()) >= t):
                raise ValueError("input value is larger than plain_modulus")
            vals = np.where(vals < 0, vals + t, vals).astype(np.uint64)
            dest = np.zeros(self.slots, dtype=np.uint64)
            dest[self._index_map[: vals.size]] = vals
            rows.append(dest)
        if not rows:
            return []
        out = np.asarray(
            ntt_inverse(np.stack(rows)[:, None, :], cd.plain_ntt_tables),
            dtype=np.uint64,
        )
        return [Plaintext(data=out[b, 0]) for b in range(len(rows))]

    def decode_batch(self, plains, signed: bool = False) -> List[List[int]]:
        """Decode MANY plaintexts with ONE forward-NTT pass (serving
        egress; identical values to per-plaintext decode)."""
        ps = list(plains)
        if not ps:
            return []
        cd = self.context.first_context_data()
        t = cd.parms.plain_modulus.value
        temp = np.zeros((len(ps), self.slots), dtype=np.uint64)
        for b, p_ in enumerate(ps):
            if p_.is_ntt_form:
                raise ValueError("plain cannot be in NTT form")
            pdata = np.asarray(p_.data)
            temp[b, : min(pdata.shape[0], self.slots)] = pdata[: self.slots]
        vals = np.asarray(
            ntt_forward(temp[:, None, :], cd.plain_ntt_tables)
        )[:, 0, :]
        out = vals[:, self._index_map].astype(np.int64)
        if signed:
            half = t >> 1
            out = np.where(out > half, out - t, out)
        return [[int(v) for v in row] for row in out]

    def decode(self, plain: Plaintext, signed: bool = False) -> List[int]:
        """plaintext poly -> slot values (batchencoder.cpp:339-420)."""
        if plain.is_ntt_form:
            raise ValueError("plain cannot be in NTT form")
        cd = self.context.first_context_data()
        t = cd.parms.plain_modulus.value
        temp = np.zeros(self.slots, dtype=np.uint64)
        pdata = np.asarray(plain.data)
        temp[: min(pdata.shape[0], self.slots)] = pdata[: self.slots]
        vals = np.asarray(ntt_forward(temp[None, :], cd.plain_ntt_tables))[0]
        out = vals[self._index_map].astype(np.int64)
        if signed:
            half = t >> 1
            out = np.where(out > half, out - t, out)
        return [int(v) for v in out]


class CKKSEncoder:
    """CKKS canonical embedding (reference: ckks.{h,cpp})."""

    def __init__(self, context: SealContext):
        if not context.parameters_set():
            raise ValueError("encryption parameters are not set correctly")
        cd = context.first_context_data()
        if cd.parms.scheme != SchemeType.CKKS:
            raise ValueError("unsupported scheme")
        self.context = context
        n = cd.parms.poly_modulus_degree
        self.slots = n >> 1
        logn = numth.get_power_of_two(n)
        self._logn = logn
        self._n = n

        # generator-5 slot map (ckks.cpp:37-56)
        m = n << 1
        gen, pos = 5, 1
        index_map = np.zeros(n, dtype=np.int64)
        for i in range(self.slots):
            index1 = (pos - 1) >> 1
            index2 = (m - pos - 1) >> 1
            index_map[i] = numth.reverse_bits(index1, logn)
            index_map[self.slots | i] = numth.reverse_bits(index2, logn)
            pos = (pos * gen) & (m - 1)
        self._index_map = index_map

        # bit-reversed root tables (ckks.cpp:58-77)
        roots = np.zeros(n, dtype=np.complex128)
        if m >= 8:
            croots = ComplexRoots(m)
            for i in range(n):
                roots[i] = croots.get_root(numth.reverse_bits(i, logn))
        elif m == 4:
            roots[0] = 1j
            roots[1] = -1j
        self._roots = roots
        self._inv_roots = np.conj(roots)

    @property
    def slot_count(self) -> int:
        return self.slots

    # -- embedding FFTs (vectorized versions of ckks.h:458-482, 723-744;
    #    batch-polymorphic over leading axes) --
    def _embedding_inverse(self, a: np.ndarray) -> np.ndarray:
        n = self._n
        logn = self._logn
        batch = a.shape[:-1]
        tt = 1
        for i in range(logn):
            mm = 1 << (logn - i)
            h = mm >> 1
            s = self._inv_roots[h : 2 * h][:, None]       # [h, 1]
            a = a.reshape(batch + (h, 2, tt))
            u = a[..., 0, :]
            v = a[..., 1, :]
            a = np.stack([u + v, (u - v) * s], axis=-2).reshape(batch + (n,))
            tt <<= 1
        return a

    def _embedding_forward(self, a: np.ndarray) -> np.ndarray:
        n = self._n
        logn = self._logn
        batch = a.shape[:-1]
        tt = n
        for i in range(logn):
            mm = 1 << i
            tt >>= 1
            s = self._roots[mm : 2 * mm][:, None]
            a = a.reshape(batch + (mm, 2, tt))
            u = a[..., 0, :]
            v = a[..., 1, :] * s
            a = np.stack([u + v, u - v], axis=-2).reshape(batch + (n,))
        return a

    # -- encode ----------------------------------------------------------
    def encode(
        self,
        values: Union[float, complex, Sequence],
        scale: float,
        parms_id=None,
    ) -> Plaintext:
        """values (<= N/2 slots of double/complex) -> NTT-form RNS plaintext
        (reference: ckks.h:405-617)."""
        if parms_id is None:
            parms_id = self.context.first_parms_id
        cd = self.context.get_context_data(parms_id)
        if cd is None:
            raise ValueError("parms_id is not valid for encryption parameters")
        parms = cd.parms
        coeff_modulus = parms.coeff_modulus
        L = len(coeff_modulus)
        n = self._n

        if isinstance(values, (int, float)):
            return self._encode_scalar(float(values), scale, cd)
        if isinstance(values, complex):
            values = [values] * self.slots
        values = list(values)
        if len(values) > self.slots:
            raise ValueError("values_size is too large")
        if scale <= 0 or int(math.log2(scale)) + 1 >= cd.total_coeff_modulus_bit_count:
            raise ValueError("scale out of bounds")

        vals_arr = np.asarray(values, dtype=np.complex128)
        conj_values = np.zeros(n, dtype=np.complex128)
        conj_values[self._index_map[: vals_arr.size]] = vals_arr
        conj_values[self._index_map[self.slots : self.slots + vals_arr.size]] = (
            np.conj(vals_arr)
        )

        conj_values = self._embedding_inverse(conj_values)
        n_inv = (1.0 / n) * scale
        conj_values *= n_inv

        reals = conj_values.real
        d = np.maximum(np.abs(reals), 1.0)
        max_coeff_bit_count = int(np.max(np.floor(np.log2(d)))) + 2
        if max_coeff_bit_count >= cd.total_coeff_modulus_bit_count:
            raise ValueError("encoded values are too large")

        dest = self._round_and_decompose(reals, cd, max_coeff_bit_count)
        out = np.asarray(ntt_forward(dest, cd.ntt_tables), dtype=np.uint64)
        return Plaintext(data=out, parms_id=cd.parms_id, scale=scale)

    def _encode_scalar(self, value: float, scale: float, cd) -> Plaintext:
        """Constant encode: all slots equal -> constant polynomial
        (reference: ckks.cpp:80-230)."""
        if scale <= 0 or int(math.log2(scale)) + 1 >= cd.total_coeff_modulus_bit_count:
            raise ValueError("scale out of bounds")
        coeffd = value * scale
        # compare in bit space: 2.0**bits overflows float64 for chains
        # past 1024 total bits (e.g. the 59-bit bootstrap layout)
        if (coeffd != 0.0 and math.frexp(abs(coeffd))[1]
                > cd.total_coeff_modulus_bit_count):
            raise ValueError("encoded value is too large")
        n = self._n
        # A constant polynomial evaluates to the constant at every NTT
        # point, so the NTT-form data IS the residue broadcast across all
        # n positions — fill directly, NO forward NTT (reference
        # ckks.cpp:128-214 fill_n's the residues with no transform).
        rounded = math.copysign(math.floor(abs(coeffd) + 0.5), coeffd)
        res = self._decompose_exact(
            np.array([rounded], dtype=np.float64), cd.parms.coeff_modulus
        )  # [L, 1]
        out = np.broadcast_to(res, (res.shape[0], n)).copy()
        return Plaintext(data=out, parms_id=cd.parms_id, scale=scale)

    def encode_int(self, value: int, parms_id=None) -> Plaintext:
        """Integer encode at scale 1 (reference: ckks.cpp:232-274)."""
        if parms_id is None:
            parms_id = self.context.first_parms_id
        cd = self.context.get_context_data(parms_id)
        coeff_modulus = cd.parms.coeff_modulus
        n = self._n
        L = len(coeff_modulus)
        # Constant poly: the broadcast residues ARE the NTT form (see
        # _encode_scalar; reference ckks.cpp:252-271 fill_n, no transform).
        dest = np.zeros((L, n), dtype=np.uint64)
        for j, mod in enumerate(coeff_modulus):
            dest[j, :] = value % mod.value
        return Plaintext(data=dest, parms_id=cd.parms_id, scale=1.0)

    def _round_and_decompose(self, reals: np.ndarray, cd, bitcount: int) -> np.ndarray:
        """Round half away from zero; decompose into RNS exactly.

        The reference splits this into three size regimes
        (ckks.h:514-607: <=64-bit, <=128-bit, generic big-int); here two
        vectorized paths cover all sizes exactly: coefficients below
        2^62 go through an exact float->int64 cast, larger ones through
        an exact mantissa/exponent split (every rounded double IS
        m * 2^e with a 53-bit integer mantissa, so its residue is
        (m mod p) * (2^e mod p) mod p — one vector mulmod against a
        cached power-of-two table).
        """
        rounded = np.sign(reals) * np.floor(np.abs(reals) + 0.5)
        pow2 = self._pow2_mod_table(cd)
        return self._decompose_exact(rounded, cd.parms.coeff_modulus, pow2)

    @staticmethod
    def _decompose_exact(rounded: np.ndarray, moduli, pow2_tab=None) -> np.ndarray:
        """Exact RNS residues of already-rounded (integer-valued) doubles.

        Coefficients below 2^62 go through an exact float->int64 cast,
        larger ones through an exact mantissa/exponent split (a rounded
        double IS m * 2^e with a 53-bit integer mantissa, so its residue
        is (m mod p) * (2^e mod p) mod p — one vector mulmod against a
        power-of-two table)."""
        L = len(moduli)
        n = rounded.shape[0]
        small = np.abs(rounded) < 2.0 ** 62
        if not small.all():
            # native fast path for the mixed/big regime (exact integers)
            from .utils import native as _native

            if _native.available():
                if pow2_tab is None:
                    mant, expo = np.frexp(rounded[~small])
                    pow2_tab = CKKSEncoder._build_pow2_table(
                        moduli, int(expo.max()) - 53 + 1
                    )
                out = _native.decompose_rounded(
                    rounded,
                    np.asarray([m.value for m in moduli], dtype=np.uint64),
                    pow2_tab,
                )
                if out is not None:
                    return out
        dest = np.zeros((L, n), dtype=np.uint64)
        if small.all():
            as_int = rounded.astype(np.int64)
            for j, mod in enumerate(moduli):
                dest[j] = np.mod(as_int, np.int64(mod.value)).astype(np.uint64)
            return dest

        big_idx = np.nonzero(~small)[0]
        as_int = np.where(small, rounded, 0.0).astype(np.int64)
        mant, expo = np.frexp(rounded[big_idx])
        m_int = (mant * 9007199254740992.0).astype(np.int64)  # *2^53, exact
        shift = expo.astype(np.int64) - 53  # >= 9 since |v| >= 2^62
        if pow2_tab is None:
            pow2_tab = CKKSEncoder._build_pow2_table(
                moduli, int(shift.max()) + 1
            )
        for j, mod in enumerate(moduli):
            p = mod.value
            dest[j] = np.mod(as_int, np.int64(p)).astype(np.uint64)
            r_m = np.mod(m_int, np.int64(p)).astype(np.uint64)
            pw = pow2_tab[j][shift]
            dest[j, big_idx] = modops.mul_mod(
                r_m, pw, np.uint64(p),
                np.uint64(mod.const_ratio[0]), np.uint64(mod.const_ratio[1]),
            )
        return dest

    @staticmethod
    def _build_pow2_table(moduli, smax: int) -> np.ndarray:
        tab = np.zeros((len(moduli), smax), dtype=np.uint64)
        for j, mod in enumerate(moduli):
            p = mod.value
            cur = 1
            for s in range(smax):
                tab[j, s] = cur
                cur = (cur * 2) % p
        return tab

    def _pow2_mod_table(self, cd) -> np.ndarray:
        """Cached [L, total_bit_count+1] table of 2^s mod q_j."""
        cache = cd.__dict__.setdefault("_ckks_pow2_cache", None)
        if cache is not None:
            return cache
        tab = self._build_pow2_table(
            cd.parms.coeff_modulus, cd.total_coeff_modulus_bit_count + 1
        )
        cd._ckks_pow2_cache = tab
        return tab

    def encode_at_base(self, values, scale: float, parms_id, moduli,
                       ntt_tables) -> np.ndarray:
        """Encode to an ARBITRARY coprime modulus set: the residues of
        the same rounded integer coefficients encode() would produce at
        this parms_id/scale, decomposed over `moduli` and transformed
        with `ntt_tables` (e.g. the key-switch extended base q ∪ P for
        raw-accumulator fused plaintext products — no reference
        analogue; the reference's multiply_plain lives at the ct base).

        Returns host uint64[len(moduli), N] in NTT form."""
        cd = self.context.get_context_data(parms_id)
        if cd is None:
            raise ValueError("parms_id is not valid for encryption parameters")
        n = self._n
        if isinstance(values, (int, float, complex)):
            values = [values] * self.slots
        values = list(values)
        if len(values) > self.slots:
            raise ValueError("values_size is too large")
        if scale <= 0 or int(math.log2(scale)) + 1 >= cd.total_coeff_modulus_bit_count:
            raise ValueError("scale out of bounds")
        vals_arr = np.asarray(values, dtype=np.complex128)
        conj_values = np.zeros(n, dtype=np.complex128)
        conj_values[self._index_map[: vals_arr.size]] = vals_arr
        conj_values[self._index_map[self.slots : self.slots + vals_arr.size]] = (
            np.conj(vals_arr)
        )
        conj_values = self._embedding_inverse(conj_values) * ((1.0 / n) * scale)
        reals = conj_values.real
        d = np.maximum(np.abs(reals), 1.0)
        if int(np.max(np.floor(np.log2(d)))) + 2 >= cd.total_coeff_modulus_bit_count:
            raise ValueError("encoded values are too large")
        rounded = np.sign(reals) * np.floor(np.abs(reals) + 0.5)
        dest = self._decompose_exact(rounded, moduli)
        return np.asarray(ntt_forward(dest, ntt_tables), dtype=np.uint64)

    # -- decode ----------------------------------------------------------
    def decode(self, plain: Plaintext, as_complex: bool = False):
        """NTT-form RNS plaintext -> slot values (reference: ckks.h:620-750)."""
        if not plain.is_ntt_form:
            raise ValueError("plain is not in NTT form")
        cd = self.context.get_context_data(plain.parms_id)
        parms = cd.parms
        L = len(parms.coeff_modulus)
        n = self._n
        if plain.scale <= 0 or int(math.log2(plain.scale)) >= cd.total_coeff_modulus_bit_count:
            raise ValueError("scale out of bounds")

        inv_scale = 1.0 / plain.scale
        data = np.asarray(
            ntt_inverse(np.asarray(plain.data, dtype=np.uint64), cd.ntt_tables),
            dtype=np.uint64,
        )  # [L, N]
        res_real = self._centered_ladder(data, cd, inv_scale)
        res = self._embedding_forward(res_real.astype(np.complex128))
        out_arr = res[self._index_map[: self.slots]]
        if as_complex:
            return out_arr.tolist()
        return out_arr.real.tolist()

    @staticmethod
    def _centered_ladder(data: np.ndarray, cd, inv_scale: float) -> np.ndarray:
        """CRT-compose [L, M] residue planes to centered doubles [M] —
        vectorized replacement for the per-coefficient big-int walk
        (reference: ckks.h:668-744): v >= (q+1)/2 decodes as -(q - v).
        The LSB-first double ladder keeps the reference's op order
        (exact); negating the positive-ladder result is bit-exact to the
        reference's subtract-each-term order (IEEE rounding is
        sign-symmetric)."""
        from .utils import native as _native

        q = cd.total_coeff_modulus
        K = max(1, (q.bit_length() + 63) // 64)
        if _native.available():
            # fused native kernel: compose + center + double ladder in
            # one pass per coefficient, bit-exact with the limb-plane
            # path below (pinned by tests/test_native.py)
            consts = mplimb.native_compose_consts(cd.rns_base, K)
            upper_c = cd.__dict__.get("_upper_limbs_native")
            if upper_c is None or upper_c.shape[0] != K:
                upper_c = mplimb.int_to_limbs(cd.upper_half_threshold, K)
                cd._upper_limbs_native = upper_c
            out = _native.crt_centered_double(
                data, consts[1], consts[2], consts[3], consts[4],
                upper_c, K, inv_scale)
            if out is not None:
                return out
        v_limbs = mplimb.compose_limbs(data, cd.rns_base)
        K = v_limbs.shape[0]
        upper = mplimb.int_to_limbs(cd.upper_half_threshold, K)[:, None]
        q_limbs = mplimb.int_to_limbs(q, K)[:, None]
        is_neg = mplimb.geq_limbs(v_limbs, upper)
        neg_mag = mplimb.sub_from_limbs(q_limbs, v_limbs)
        mag = np.where(is_neg[None, :], neg_mag, v_limbs)
        res_real = mplimb.ladder_to_double(mag, inv_scale)
        return np.where(is_neg, -res_real, res_real)

    def encode_batch(self, values_list, scale: float, parms_id=None):
        """Encode MANY slot-value vectors in one set of vectorized passes
        (batched embedding FFT, one decompose, one forward NTT over the
        [B, L, N] stack) — the serving-ingestion twin of decode_batch.
        Returns a list of Plaintexts identical to per-vector encode()."""
        if parms_id is None:
            parms_id = self.context.first_parms_id
        cd = self.context.get_context_data(parms_id)
        if cd is None:
            raise ValueError("parms_id is not valid for encryption parameters")
        if scale <= 0 or int(math.log2(scale)) + 1 >= cd.total_coeff_modulus_bit_count:
            raise ValueError("scale out of bounds")
        n = self._n
        rows = []
        for values in values_list:
            values = list(values)
            if len(values) > self.slots:
                raise ValueError("values_size is too large")
            row = np.zeros(self.slots, dtype=np.complex128)
            row[: len(values)] = np.asarray(values, dtype=np.complex128)
            rows.append(row)
        if not rows:
            return []
        vals = np.stack(rows)                              # [B, slots]
        B = vals.shape[0]
        conj = np.zeros((B, n), dtype=np.complex128)
        conj[:, self._index_map[: self.slots]] = vals
        conj[:, self._index_map[self.slots :]] = np.conj(vals)
        conj = self._embedding_inverse(conj) * ((1.0 / n) * scale)
        reals = conj.real
        d = np.maximum(np.abs(reals), 1.0)
        if int(np.max(np.floor(np.log2(d)))) + 2 >= cd.total_coeff_modulus_bit_count:
            raise ValueError("encoded values are too large")
        rounded = np.sign(reals) * np.floor(np.abs(reals) + 0.5)
        pow2 = self._pow2_mod_table(cd)
        dest = self._decompose_exact(
            rounded.reshape(B * n), cd.parms.coeff_modulus, pow2
        )                                                  # [L, B*n]
        L = len(cd.parms.coeff_modulus)
        planes = np.moveaxis(dest.reshape(L, B, n), 1, 0)  # [B, L, n]
        out = np.asarray(
            ntt_forward(np.ascontiguousarray(planes), cd.ntt_tables),
            dtype=np.uint64,
        )
        return [
            Plaintext(data=out[b], parms_id=cd.parms_id, scale=scale)
            for b in range(B)
        ]

    def decode_batch(self, plains, as_complex: bool = False):
        """Decode MANY plaintexts (homogeneous parms_id/scale) in one set
        of vectorized passes — the serving egress twin of
        Decryptor.decrypt_batch (no reference analogue).  Returns a list
        of slot-value lists, identical to per-plaintext decode()."""
        ps = list(plains)
        if not ps:
            return []
        cd = self.context.get_context_data(ps[0].parms_id)
        scale = ps[0].scale
        for p in ps:
            if not p.is_ntt_form:
                raise ValueError("plain is not in NTT form")
            if p.parms_id != ps[0].parms_id or p.scale != scale:
                raise ValueError("decode_batch needs homogeneous plaintexts")
        if scale <= 0 or int(math.log2(scale)) >= cd.total_coeff_modulus_bit_count:
            raise ValueError("scale out of bounds")
        n = self._n
        B = len(ps)
        L = len(cd.parms.coeff_modulus)
        data = np.stack([np.asarray(p.data, dtype=np.uint64) for p in ps])
        data = np.asarray(ntt_inverse(data, cd.ntt_tables), dtype=np.uint64)
        flat = np.ascontiguousarray(np.moveaxis(data, 0, 1)).reshape(L, B * n)
        res_real = self._centered_ladder(flat, cd, 1.0 / scale).reshape(B, n)
        res = self._embedding_forward(res_real.astype(np.complex128))
        out = res[:, self._index_map[: self.slots]]
        if as_complex:
            return [row.tolist() for row in out]
        return [row.real.tolist() for row in out]


class IntegerEncoder:
    """Legacy base-2 signed-digit integer encoder (BFV only)
    (reference: intencoder.{h,cpp})."""

    def __init__(self, context: SealContext):
        cd = context.first_context_data()
        if cd.parms.scheme != SchemeType.BFV:
            raise ValueError("unsupported scheme")
        self.context = context
        self.plain_modulus = cd.parms.plain_modulus.value

    def encode(self, value: int) -> Plaintext:
        t = self.plain_modulus
        if value == 0:
            return Plaintext(data=np.zeros(1, dtype=np.uint64))
        negative = value < 0
        mag = abs(value)
        bits = []
        while mag:
            bits.append(mag & 1)
            mag >>= 1
        coeffs = np.zeros(len(bits), dtype=np.uint64)
        for i, b in enumerate(bits):
            if b:
                coeffs[i] = (t - 1) if negative else 1
        return Plaintext(data=coeffs)

    def decode(self, plain: Plaintext) -> int:
        t = self.plain_modulus
        half = t >> 1
        total = 0
        coeffs = np.asarray(plain.data)
        for i in range(len(coeffs) - 1, -1, -1):
            c = int(coeffs[i])
            digit = c - t if c > half else c
            total = total * 2 + digit
        return total
