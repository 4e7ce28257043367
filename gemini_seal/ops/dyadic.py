"""Coefficient-wise polynomial kernels over [..., L, N] residue tensors.

JAX rework of the reference's per-limb scalar loops
(reference: native/src/seal/util/polyarithsmallmod.{h,cpp}).  The iterator
nesting [poly][rns_limb][coeff] becomes plain array axes; each op is a
vectorized XLA program broadcasting per-limb constants shaped [L, 1] against
data [..., L, N].

The `limbs` argument everywhere is a LimbConstants bundle carrying the
modulus vector and its Barrett ratios, pre-shaped for broadcast.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..modulus import Modulus
from . import modops
from .backend import xp

__all__ = [
    "LimbConstants",
    "add_poly",
    "sub_poly",
    "negate_poly",
    "multiply_poly_scalar",
    "dyadic_product",
    "modulo_poly_coeffs",
    "negacyclic_shift_poly",
    "negacyclic_mono_mul_poly",
    "poly_infty_norm",
]


@dataclass(frozen=True)
class LimbConstants:
    """Per-limb modulus constants, broadcast-ready against [..., L, N].

    p, ratio0, ratio1: uint64[L, 1] (floor(2^128/p) low/high words —
    reference: modulus.h:122-129).
    """

    p: np.ndarray
    ratio0: np.ndarray
    ratio1: np.ndarray

    @staticmethod
    def from_moduli(moduli) -> "LimbConstants":
        vals, r0, r1 = [], [], []
        for m in moduli:
            if not isinstance(m, Modulus):
                m = Modulus(int(m))
            vals.append(m.value)
            r0.append(m.const_ratio[0])
            r1.append(m.const_ratio[1])
        shape = (len(vals), 1)
        return LimbConstants(
            p=np.array(vals, dtype=np.uint64).reshape(shape),
            ratio0=np.array(r0, dtype=np.uint64).reshape(shape),
            ratio1=np.array(r1, dtype=np.uint64).reshape(shape),
        )


# Registered eagerly: the package itself imports jax (models/, parallel/),
# so there is no import-cost to defer; registration must precede any jit
# trace that closes over a LimbConstants.
import jax  # noqa: E402

jax.tree_util.register_pytree_node(
    LimbConstants,
    lambda c: ((c.p, c.ratio0, c.ratio1), None),
    lambda _, ch: LimbConstants(*ch),
)


def add_poly(a, b, limbs: LimbConstants):
    """(a + b) mod q_i per limb (polyarithsmallmod.h:261-360)."""
    return modops.add_mod(a, b, limbs.p)


def sub_poly(a, b, limbs: LimbConstants):
    return modops.sub_mod(a, b, limbs.p)


def negate_poly(a, limbs: LimbConstants):
    return modops.neg_mod(a, limbs.p)


def multiply_poly_scalar(a, scalar, limbs: LimbConstants):
    """a * s_i mod q_i; scalar is [L, 1] (or scalar) per-limb values
    (polyarithsmallmod.h:471-528)."""
    return modops.mul_mod(a, scalar, limbs.p, limbs.ratio0, limbs.ratio1)


def dyadic_product(a, b, limbs: LimbConstants):
    """Hadamard product in NTT domain (polyarithsmallmod.h:530-597)."""
    return modops.mul_mod(a, b, limbs.p, limbs.ratio0, limbs.ratio1)


def modulo_poly_coeffs(a, limbs: LimbConstants):
    """Reduce arbitrary u64 coefficients into [0, q_i)
    (polyarithsmallmod.h:21-174).  Valid for inputs < 2^63 per limb
    (barrett_reduce_63 contract); use barrett_reduce_128 for wider."""
    return modops.barrett_reduce_64(a, limbs.p, limbs.ratio1)


def negacyclic_shift_poly(a, shift: int, limbs: LimbConstants):
    """Multiply by x^shift in R_q = Z_q[X]/(X^N+1)
    (polyarithsmallmod.h:601-657): a rotation of the coefficient axis with
    sign flip on wrap-around.  `shift` is a static Python int.
    """
    n = a.shape[-1]
    shift = shift % (2 * n)
    if shift == 0:
        return a
    m_ = xp(a)
    rot = shift % n
    rolled = m_.roll(a, rot, axis=-1)
    # Coefficients that wrapped past X^N pick up a -1.
    wrapped = np.arange(n) < rot
    if (shift // n) % 2 == 1:
        wrapped = ~wrapped  # shifting by n negates everything
    return m_.where(wrapped, modops.neg_mod(rolled, limbs.p), rolled)


def negacyclic_mono_mul_poly(a, mono_coeff, mono_exponent: int, limbs: LimbConstants):
    """a * (c * x^e) in R_q (polyarithsmallmod.h:659-804); mono_coeff is a
    per-limb [L, 1] residue (or broadcastable scalar)."""
    scaled = multiply_poly_scalar(a, mono_coeff, limbs)
    return negacyclic_shift_poly(scaled, mono_exponent, limbs)


def poly_infty_norm(a, limbs: LimbConstants):
    """Max |a_i| under centered lift per limb (polyarithsmallmod.h:599)."""
    m_ = xp(a)
    p = limbs.p
    half = p >> np.uint64(1)
    mag = m_.where(a > half, p - a, a)
    return m_.max(mag, axis=-1)
