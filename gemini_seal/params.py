"""Encryption parameters (host side).

JAX rework of the reference's EncryptionParameters
(reference: native/src/seal/encryptionparams.{h,cpp}).  The ``parms_id`` is
the blake2b-256 hash of [scheme, N, q_0..q_{L-1}, t] as little-endian u64
words (reference: encryptionparams.cpp:133-166), so identifiers agree with
the reference bit-for-bit — the anchor for serialization interop.
"""

from __future__ import annotations

import enum
from typing import List, Optional, Sequence, Tuple

from .modulus import Modulus
from .utils.blake2 import hash_uint64

__all__ = ["SchemeType", "EncryptionParameters", "PARMS_ID_ZERO", "ParmsId"]

ParmsId = Tuple[int, int, int, int]
PARMS_ID_ZERO: ParmsId = (0, 0, 0, 0)


class SchemeType(enum.IntEnum):
    """Scheme identifiers (reference: encryptionparams.h:24-36)."""

    none = 0
    BFV = 1
    CKKS = 2


class EncryptionParameters:
    """Mutable parameter holder; hashes itself into ``parms_id`` on change."""

    def __init__(self, scheme: SchemeType = SchemeType.none):
        self._scheme = SchemeType(scheme)
        self._poly_modulus_degree: int = 0
        self._coeff_modulus: List[Modulus] = []
        self._plain_modulus: Modulus = Modulus(0)
        self._n_special_primes: int = 1  # fork: encryptionparams.h:205-214
        self._random_seed: Optional[Tuple[int, ...]] = None
        self._parms_id: ParmsId = PARMS_ID_ZERO
        self._compute_parms_id()

    # -- setters ----------------------------------------------------------
    def set_poly_modulus_degree(self, degree: int):
        if self._scheme == SchemeType.none and degree:
            raise ValueError("poly_modulus_degree is not supported for this scheme")
        self._poly_modulus_degree = int(degree)
        self._compute_parms_id()

    def set_coeff_modulus(self, coeff_modulus: Sequence):
        if self._scheme == SchemeType.none and len(coeff_modulus):
            raise ValueError("coeff_modulus is not supported for this scheme")
        self._coeff_modulus = [
            m if isinstance(m, Modulus) else Modulus(int(m)) for m in coeff_modulus
        ]
        self._compute_parms_id()

    def set_plain_modulus(self, plain_modulus):
        if self._scheme != SchemeType.BFV and (
            not isinstance(plain_modulus, Modulus) or plain_modulus.value != 0
        ) and plain_modulus != 0:
            raise ValueError("plain_modulus is not supported for this scheme")
        self._plain_modulus = (
            plain_modulus
            if isinstance(plain_modulus, Modulus)
            else Modulus(int(plain_modulus))
        )
        self._compute_parms_id()

    def set_n_special_primes(self, n: int):
        """Number of special primes for hybrid key-switching (fork API)."""
        if n < 1:
            raise ValueError("n_special_primes must be >= 1")
        self._n_special_primes = int(n)
        # Not part of parms_id (reference hashes scheme|N|q|t only).

    def set_random_seed(self, seed: Sequence[int]):
        """Pin the PRNG seed (8 u64 words) for reproducible encryption."""
        seed = tuple(int(s) for s in seed)
        if len(seed) != 8:
            raise ValueError("seed must have 8 u64 words")
        self._random_seed = seed

    # -- getters ----------------------------------------------------------
    @property
    def scheme(self) -> SchemeType:
        return self._scheme

    @property
    def poly_modulus_degree(self) -> int:
        return self._poly_modulus_degree

    @property
    def coeff_modulus(self) -> List[Modulus]:
        return list(self._coeff_modulus)

    @property
    def plain_modulus(self) -> Modulus:
        return self._plain_modulus

    @property
    def n_special_primes(self) -> int:
        return self._n_special_primes

    @property
    def random_seed(self) -> Optional[Tuple[int, ...]]:
        return self._random_seed

    @property
    def parms_id(self) -> ParmsId:
        return self._parms_id

    # -- internals ---------------------------------------------------------
    def _compute_parms_id(self):
        words = [int(self._scheme), self._poly_modulus_degree]
        words += [m.value for m in self._coeff_modulus]
        # plain_modulus is a single u64 word (uint64_count == 1) for all
        # valid parameter sets.
        words.append(self._plain_modulus.value)
        self._parms_id = hash_uint64(words)
        if self._parms_id == PARMS_ID_ZERO:
            raise RuntimeError("parms_id cannot be zero")

    def clone(self) -> "EncryptionParameters":
        out = EncryptionParameters(self._scheme)
        out._poly_modulus_degree = self._poly_modulus_degree
        out._coeff_modulus = list(self._coeff_modulus)
        out._plain_modulus = self._plain_modulus
        out._n_special_primes = self._n_special_primes
        out._random_seed = self._random_seed
        out._compute_parms_id()
        return out

    def __eq__(self, other):
        return (
            isinstance(other, EncryptionParameters)
            and self._parms_id == other._parms_id
            and self._n_special_primes == other._n_special_primes
        )

    def __hash__(self):
        return hash(self._parms_id)

    def __repr__(self):
        return (
            f"EncryptionParameters(scheme={self._scheme.name}, "
            f"N={self._poly_modulus_degree}, L={len(self._coeff_modulus)}, "
            f"t={self._plain_modulus.value}, nsp={self._n_special_primes})"
        )
