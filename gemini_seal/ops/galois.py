"""Galois automorphisms x -> x^elt on R_q (JAX gathers).

JAX rework of the reference's GaloisTool
(reference: native/src/seal/util/galois.{h,cpp}).  Both the power-basis
version (index map + sign flip, galois.cpp:144-186) and the NTT-domain
version (a bit-reversed index permutation, galois.cpp:18-47) become
precomputed gather indices applied with one fused gather per
[..., L, N] tensor instead of scalar loops.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..utils import numth
from . import modops
from .backend import xp
from .dyadic import LimbConstants

__all__ = ["GaloisTool"]


class GaloisTool:
    """Per-degree automorphism helper.

    The fork sets the rotation generator to 5 (galois.h:169, matching the
    CKKS slot map's generator in ckks.cpp:40; upstream SEAL used 3)."""

    GENERATOR = 5

    def __init__(self, coeff_count_power: int):
        self.coeff_count_power = coeff_count_power
        self.coeff_count = 1 << coeff_count_power
        self._ntt_tables: Dict[int, np.ndarray] = {}
        self._coeff_tables: Dict[int, tuple] = {}

    # -- element maps -----------------------------------------------------
    def get_elt_from_step(self, step: int, generator: int = None) -> int:
        """Rotation step -> Galois element gen^step mod 2N
        (reference: galois.cpp:49-91; the fork's generator is 5).

        Pass generator=3 for rotations over reference-compatible
        (BatchEncoder compat_gen3) slot orderings."""
        n = self.coeff_count
        m = 2 * n
        if step == 0:
            return m - 1
        sign = step < 0
        pos_step = abs(step)
        if pos_step >= (n >> 1):
            raise ValueError("step count too large")
        pos_step &= m - 1
        step = (n >> 1) - pos_step if sign else pos_step
        gen = self.GENERATOR if generator is None else generator
        elt = 1
        for _ in range(step):
            elt = (elt * gen) & (m - 1)
        return elt

    def get_elts_from_steps(self, steps: Sequence[int]) -> List[int]:
        return [self.get_elt_from_step(s) for s in steps]

    def get_elts_all(self) -> List[int]:
        """Default key set: conjugation + power-of-3 ladder
        (reference: galois.cpp:102-127)."""
        m = 2 * self.coeff_count
        elts = [m - 1]
        pos = self.GENERATOR
        neg = numth.try_invert_uint_mod(self.GENERATOR, m)
        for _ in range(self.coeff_count_power - 1):
            elts.append(pos)
            pos = (pos * pos) & (m - 1)
            elts.append(neg)
            neg = (neg * neg) & (m - 1)
        return elts

    # -- permutation tables ----------------------------------------------
    def _coeff_table(self, galois_elt: int):
        """Power-basis automorphism as (gather index, sign flag) per output
        position: result[(i*elt mod 2n) fold] = +-operand[i]
        (reference: galois.cpp:144-186), inverted into a gather."""
        hit = self._coeff_tables.get(galois_elt)
        if hit is not None:
            return hit
        n = self.coeff_count
        src = np.zeros(n, dtype=np.int64)    # result[j] reads operand[src[j]]
        neg = np.zeros(n, dtype=bool)
        for i in range(n):
            index_raw = i * galois_elt
            index = index_raw & (n - 1)
            src[index] = i
            neg[index] = bool((index_raw >> self.coeff_count_power) & 1)
        entry = (src, neg)
        self._coeff_tables[galois_elt] = entry
        return entry

    def _ntt_table(self, galois_elt: int) -> np.ndarray:
        """NTT-domain permutation (reference: galois.cpp:18-47)."""
        hit = self._ntt_tables.get(galois_elt)
        if hit is not None:
            return hit
        n = self.coeff_count
        logn = self.coeff_count_power
        table = np.zeros(n, dtype=np.int64)
        for i in range(n, 2 * n):
            reversed_i = numth.reverse_bits(i, logn + 1)
            index_raw = ((galois_elt * reversed_i) >> 1) & (n - 1)
            table[i - n] = numth.reverse_bits(index_raw, logn)
        self._ntt_tables[galois_elt] = table
        return table

    # -- application ------------------------------------------------------
    def apply_galois(self, x, galois_elt: int, limbs: LimbConstants):
        """Power-basis automorphism over [..., L, N]."""
        self._check_elt(galois_elt)
        src, neg = self._coeff_table(galois_elt)
        m_ = xp(x)
        gathered = m_.take(x, src, axis=-1)
        return m_.where(neg, modops.neg_mod(gathered, limbs.p), gathered)

    def apply_galois_ntt(self, x, galois_elt: int):
        """NTT-domain automorphism (pure permutation) over [..., L, N]."""
        self._check_elt(galois_elt)
        table = self._ntt_table(galois_elt)
        return xp(x).take(x, table, axis=-1)

    def _check_elt(self, galois_elt: int):
        if not (galois_elt & 1) or galois_elt >= 2 * self.coeff_count:
            raise ValueError("Galois element is not valid")
