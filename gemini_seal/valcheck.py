"""Validity checks for framework objects against a context.

JAX rework of the reference's valcheck layer
(reference: native/src/seal/valcheck.{h,cpp}): metadata checks (parms_id
membership, shape congruence), buffer checks (sizes, value bounds), and the
combined is_valid_for.  Data-level bound checks pull device tensors to host
— they are debug/ingest-boundary tools, not hot-path ops (the reference
gates the equivalents behind SEAL_DEBUG for the same reason).
"""

from __future__ import annotations

import numpy as np

from .ciphertext import Ciphertext, Plaintext
from .context import SealContext
from .keys import GaloisKeys, KSwitchKeys, PublicKey, RelinKeys, SecretKey
from .modulus import CIPHERTEXT_SIZE_MAX, CIPHERTEXT_SIZE_MIN
from .params import PARMS_ID_ZERO, SchemeType

__all__ = ["is_metadata_valid_for", "is_buffer_valid", "is_data_valid_for", "is_valid_for"]


def is_metadata_valid_for(obj, context: SealContext, allow_pure_key_level: bool = False) -> bool:
    """Shape/parms_id congruence (valcheck.h:32-90)."""
    if context is None or not context.parameters_set():
        return False
    if isinstance(obj, Plaintext):
        if obj.parms_id == PARMS_ID_ZERO:
            cd = context.first_context_data()
            return obj.coeff_count <= cd.parms.poly_modulus_degree
        cd = context.get_context_data(obj.parms_id)
        if cd is None:
            return False
        arr = np.asarray(obj.data)
        expected = (len(cd.parms.coeff_modulus), cd.parms.poly_modulus_degree)
        return arr.shape == expected or arr.size == expected[0] * expected[1]
    if isinstance(obj, Ciphertext):
        cd = context.get_context_data(obj.parms_id)
        if cd is None:
            return False
        if (not allow_pure_key_level and obj.parms_id == context.key_parms_id
                and context.using_keyswitching):
            # ordinary ciphertexts live at or below the first data level;
            # only key-switching keys legitimately sit at the key level
            # (valcheck.cpp:70-84 is_metadata_valid_for's key-level gate)
            return False
        if not (CIPHERTEXT_SIZE_MIN <= obj.size <= CIPHERTEXT_SIZE_MAX):
            return False
        return (
            obj.coeff_modulus_size == len(cd.parms.coeff_modulus)
            and obj.poly_modulus_degree == cd.parms.poly_modulus_degree
        )
    if isinstance(obj, SecretKey):
        if obj.parms_id != context.key_parms_id:
            return False
        cd = context.key_context_data()
        return tuple(obj.data.shape) == (
            len(cd.parms.coeff_modulus), cd.parms.poly_modulus_degree,
        )
    if isinstance(obj, PublicKey):
        return (
            obj.parms_id == context.key_parms_id
            and obj.data.is_ntt_form
            and is_metadata_valid_for(obj.data, context, allow_pure_key_level=True)
        )
    if isinstance(obj, KSwitchKeys):
        if obj.parms_id != context.key_parms_id:
            return False
        for row in obj.keys:
            for pk in row:
                if not is_metadata_valid_for(pk, context):
                    return False
        return True
    return False


def is_buffer_valid(obj) -> bool:
    """Size congruence of the raw buffer (valcheck.h:92-130)."""
    if isinstance(obj, Plaintext):
        return np.asarray(obj.data).size > 0
    if isinstance(obj, Ciphertext):
        return obj.data.ndim == 3 and obj.data.shape[0] == obj.size
    if isinstance(obj, (SecretKey, PublicKey)):
        return True
    if isinstance(obj, KSwitchKeys):
        return all(is_buffer_valid(pk.data) for row in obj.keys for pk in row)
    return False


def is_data_valid_for(obj, context: SealContext) -> bool:
    """Value bounds per limb (valcheck.h:132-170); pulls data to host."""
    if isinstance(obj, Plaintext):
        if obj.parms_id == PARMS_ID_ZERO:
            t = context.first_context_data().parms.plain_modulus.value
            if context.first_context_data().parms.scheme == SchemeType.BFV:
                return bool(np.all(np.asarray(obj.data) < t))
            return True
        cd = context.get_context_data(obj.parms_id)
        if cd is None:
            return False
        mods = np.array([m.value for m in cd.parms.coeff_modulus], dtype=np.uint64)
        arr = np.asarray(obj.data).reshape(len(mods), -1)
        return bool(np.all(arr < mods[:, None]))
    if isinstance(obj, Ciphertext):
        cd = context.get_context_data(obj.parms_id)
        if cd is None:
            return False
        mods = np.array([m.value for m in cd.parms.coeff_modulus], dtype=np.uint64)
        arr = np.asarray(obj.data)
        return bool(np.all(arr < mods[None, :, None]))
    if isinstance(obj, SecretKey):
        cd = context.key_context_data()
        mods = np.array([m.value for m in cd.parms.coeff_modulus], dtype=np.uint64)
        return bool(np.all(np.asarray(obj.data) < mods[:, None]))
    if isinstance(obj, PublicKey):
        return is_data_valid_for(obj.data, context)
    if isinstance(obj, KSwitchKeys):
        return all(is_data_valid_for(pk.data, context) for row in obj.keys for pk in row)
    return False


def is_valid_for(obj, context: SealContext) -> bool:
    """Full check (valcheck.h:172-197)."""
    return (
        is_metadata_valid_for(obj, context)
        and is_buffer_valid(obj)
        and is_data_valid_for(obj, context)
    )
