"""Plaintext and Ciphertext containers.

JAX rework of the reference's data objects
(reference: native/src/seal/plaintext.{h,cpp}, ciphertext.{h,cpp}).  The
reference's flat IntArray with [size][L][N] strides becomes a dense
``uint64[size, L, N]`` device tensor plus a host-side metadata pytree —
the direct analogue of the iterator framework's nesting (util/iterator.h),
expressed as array axes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .params import PARMS_ID_ZERO, ParmsId
from .modulus import CIPHERTEXT_SIZE_MAX, CIPHERTEXT_SIZE_MIN

__all__ = ["Plaintext", "Ciphertext"]


@dataclass
class Plaintext:
    """BFV: coefficient vector mod t (degree < N), parms_id zero.
    CKKS: RNS NTT poly [L, N] tagged with parms_id and scale
    (reference: plaintext.h:58+).
    """

    data: np.ndarray                      # u64[coeff_count] or u64[L, N]
    parms_id: ParmsId = PARMS_ID_ZERO
    scale: float = 1.0

    @property
    def is_ntt_form(self) -> bool:
        return self.parms_id != PARMS_ID_ZERO

    @property
    def coeff_count(self) -> int:
        return int(np.prod(self.data.shape))

    def significant_coeff_count(self) -> int:
        if self.is_ntt_form:
            return self.coeff_count
        nz = np.nonzero(np.asarray(self.data))[0]
        return int(nz[-1]) + 1 if nz.size else 0

    @staticmethod
    def from_coeffs(coeffs, n: Optional[int] = None) -> "Plaintext":
        arr = np.asarray(coeffs, dtype=np.uint64)
        return Plaintext(data=arr)

    @staticmethod
    def from_hex(hex_poly: str) -> "Plaintext":
        """Parse the reference's hex-polynomial format, e.g. '3x^2 + 1'."""
        hex_poly = hex_poly.strip()
        if not hex_poly:
            return Plaintext(data=np.zeros(1, dtype=np.uint64))
        terms = {}
        for term in hex_poly.replace("-", "+-").split("+"):
            term = term.strip()
            if not term:
                continue
            if "x^" in term:
                c, e = term.split("x^")
                c = c.strip() or "1"
            elif "x" in term:
                c = term.split("x")[0].strip() or "1"
                e = "1"
            else:
                c, e = term, "0"
            terms[int(e)] = int(c, 16)
        degree = max(terms) if terms else 0
        data = np.zeros(degree + 1, dtype=np.uint64)
        for e, c in terms.items():
            data[e] = c
        return Plaintext(data=data)

    def to_hex(self) -> str:
        """Render as the reference's hex-polynomial string."""
        if self.is_ntt_form:
            raise ValueError("cannot render NTT-form plaintext as hex poly")
        coeffs = np.asarray(self.data)
        parts = []
        for e in range(len(coeffs) - 1, -1, -1):
            c = int(coeffs[e])
            if c == 0:
                continue
            if e == 0:
                parts.append(f"{c:x}")
            elif e == 1:
                parts.append(f"{c:x}x" if c != 1 else "1x")
            else:
                parts.append(f"{c:x}x^{e}" if c != 1 else f"1x^{e}")
        return " + ".join(parts) if parts else "0"


@dataclass
class Ciphertext:
    """size polynomials of L RNS limbs of N coefficients
    (reference: ciphertext.h:56+, data layout :709-721)."""

    data: object                          # u64[size, L, N]
    parms_id: ParmsId
    is_ntt_form: bool = False
    scale: float = 1.0

    @property
    def size(self) -> int:
        return int(self.data.shape[0])

    @property
    def coeff_modulus_size(self) -> int:
        return int(self.data.shape[1])

    @property
    def poly_modulus_degree(self) -> int:
        return int(self.data.shape[2])

    def copy(self) -> "Ciphertext":
        return Ciphertext(self.data, self.parms_id, self.is_ntt_form, self.scale)

    def is_transparent(self) -> bool:
        """True if c_1.. are all zero — decryptable without the secret key
        (reference: ciphertext.h:700-707)."""
        if self.size < CIPHERTEXT_SIZE_MIN:
            return True
        from .ops.backend import is_device_array

        if is_device_array(self.data):
            # traced/device data: the check runs on the host plane only
            # (the reference gates it behind SEAL_THROW_ON_TRANSPARENT_CIPHERTEXT)
            return False
        return bool(np.all(np.asarray(self.data[1:]) == 0))

    @staticmethod
    def zero(context_data, size: int = 2, is_ntt_form: bool = False) -> "Ciphertext":
        if not CIPHERTEXT_SIZE_MIN <= size <= CIPHERTEXT_SIZE_MAX:
            raise ValueError("invalid ciphertext size")
        parms = context_data.parms
        shape = (size, len(parms.coeff_modulus), parms.poly_modulus_degree)
        return Ciphertext(
            data=np.zeros(shape, dtype=np.uint64),
            parms_id=context_data.parms_id,
            is_ntt_form=is_ntt_form,
        )
