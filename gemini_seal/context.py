"""SEALContext: parameter validation + per-level precompute chain (host).

JAX rework of the reference's SEALContext / ContextData
(reference: native/src/seal/context.{h,cpp}).  Validation reproduces the
reference's error taxonomy (context.cpp:21-133) and qualifier flags; each
chain level carries exact-int and numpy constant tables that the device
kernels consume.  The modulus-switching chain is the doubly-linked list of
levels keyed by parms_id (context.cpp:423-453), including the fork's
n_special_primes shift of first_parms_id (context.cpp:524-539).

Departure from the reference: NTT tables are built once per (modulus, N) and
shared across levels, and all device constants are assembled lazily per
level — under jit they compile into on-device executable constants, so no
host->device transfer happens on the hot path.
"""

from __future__ import annotations

import enum
from typing import Dict, List, Optional

import numpy as np

from .modulus import (
    COEFF_MOD_COUNT_MAX,
    COEFF_MOD_COUNT_MIN,
    PLAIN_MOD_BIT_COUNT_MAX,
    PLAIN_MOD_BIT_COUNT_MIN,
    POLY_MOD_DEGREE_MAX,
    POLY_MOD_DEGREE_MIN,
    USER_MOD_BIT_COUNT_MAX,
    USER_MOD_BIT_COUNT_MIN,
    CoeffModulus,
    SecLevelType,
)
from .params import PARMS_ID_ZERO, EncryptionParameters, ParmsId, SchemeType
from .ops.ntt import NTTTables, build_ntt_tables
from .ops.dyadic import LimbConstants
from .utils import numth
from .utils.rns import RNSBase, RNSTool

__all__ = ["ErrorType", "EncryptionParameterQualifiers", "ContextData", "SealContext"]


class ErrorType(enum.Enum):
    """Validation error taxonomy (reference: context.h error_type)."""

    none = ("none", "constructed but not yet validated")
    success = ("success", "valid")
    invalid_scheme = ("invalid_scheme", "scheme must be BFV or CKKS")
    invalid_coeff_modulus_size = (
        "invalid_coeff_modulus_size",
        "coeff_modulus's primes' count is not bounded by SEAL_COEFF_MOD_COUNT_MIN(MAX)",
    )
    invalid_coeff_modulus_bit_count = (
        "invalid_coeff_modulus_bit_count",
        "coeff_modulus's primes' bit counts are not bounded by SEAL_USER_MOD_BIT_COUNT_MIN(MAX)",
    )
    invalid_coeff_modulus_no_ntt = (
        "invalid_coeff_modulus_no_ntt",
        "coeff_modulus's primes are not congruent to 1 modulo (2 * poly_modulus_degree)",
    )
    invalid_poly_modulus_degree = (
        "invalid_poly_modulus_degree",
        "poly_modulus_degree is not bounded by SEAL_POLY_MOD_DEGREE_MIN(MAX)",
    )
    invalid_poly_modulus_degree_non_power_of_two = (
        "invalid_poly_modulus_degree_non_power_of_two",
        "poly_modulus_degree is not a power of two",
    )
    invalid_parameters_too_large = (
        "invalid_parameters_too_large",
        "parameters are too large to fit in size_t type",
    )
    invalid_parameters_insecure = (
        "invalid_parameters_insecure",
        "parameters are not compliant with HomomorphicEncryption.org security standard",
    )
    failed_creating_rns_base = ("failed_creating_rns_base", "RNSBase cannot be constructed")
    invalid_plain_modulus_bit_count = (
        "invalid_plain_modulus_bit_count",
        "plain_modulus's bit count is not bounded by SEAL_PLAIN_MOD_BIT_COUNT_MIN(MAX)",
    )
    invalid_plain_modulus_coprimality = (
        "invalid_plain_modulus_coprimality",
        "plain_modulus is not coprime to coeff_modulus",
    )
    invalid_plain_modulus_too_large = (
        "invalid_plain_modulus_too_large",
        "plain_modulus is not smaller than coeff_modulus",
    )
    invalid_plain_modulus_nonzero = (
        "invalid_plain_modulus_nonzero",
        "plain_modulus is not zero",
    )
    failed_creating_rns_tool = ("failed_creating_rns_tool", "RNSTool cannot be constructed")

    @property
    def error_name(self) -> str:
        return self.value[0]

    @property
    def message(self) -> str:
        return self.value[1]


class EncryptionParameterQualifiers:
    """Validation outcome flags (reference: context.h:61-213)."""

    def __init__(self):
        self.parameter_error: ErrorType = ErrorType.none
        self.using_fft = False
        self.using_ntt = False
        self.using_batching = False
        self.using_fast_plain_lift = False
        self.using_descending_modulus_chain = False
        self.sec_level: SecLevelType = SecLevelType.none

    def parameters_set(self) -> bool:
        return self.parameter_error == ErrorType.success

    @property
    def parameter_error_name(self) -> str:
        return self.parameter_error.error_name

    @property
    def parameter_error_message(self) -> str:
        return self.parameter_error.message


class ContextData:
    """Per-level precomputed data (reference: context.h:252-521)."""

    def __init__(self, parms: EncryptionParameters):
        self.parms = parms
        self.qualifiers = EncryptionParameterQualifiers()
        self.total_coeff_modulus: int = 0
        self.total_coeff_modulus_bit_count: int = 0
        self.rns_base: Optional[RNSBase] = None
        self.ntt_tables: Optional[NTTTables] = None
        self.plain_ntt_tables: Optional[NTTTables] = None
        self.rns_tool: Optional[RNSTool] = None
        # BFV constants
        self.coeff_div_plain_modulus: Optional[np.ndarray] = None  # Delta, RNS [L]
        self.upper_half_increment: Optional[np.ndarray] = None     # q mod t remainder, RNS [L]
        self.coeff_modulus_mod_plain_modulus: int = 0
        self.plain_upper_half_threshold: int = 0
        self.plain_upper_half_increment: Optional[np.ndarray] = None  # [L]
        # CKKS constant
        self.upper_half_threshold: int = 0  # (q + 1) / 2, big int
        # chain links
        self.prev_context_data: Optional["ContextData"] = None
        self.next_context_data: Optional["ContextData"] = None
        self.chain_index: int = 0
        # lazy device-side caches
        self._limb_constants: Optional[LimbConstants] = None
        self._galois_tool = None
        self._device_rns_tool = None

    @property
    def parms_id(self) -> ParmsId:
        return self.parms.parms_id

    @property
    def limb_constants(self) -> LimbConstants:
        if self._limb_constants is None:
            self._limb_constants = LimbConstants.from_moduli(self.parms.coeff_modulus)
        return self._limb_constants

    @property
    def device_rns_tool(self):
        if self._device_rns_tool is None:
            from .ops.rnsops import DeviceRNSTool

            self._device_rns_tool = DeviceRNSTool(self.rns_tool)
        return self._device_rns_tool

    @property
    def galois_tool(self):
        if self._galois_tool is None:
            from .ops.galois import GaloisTool

            log_n = numth.get_power_of_two(self.parms.poly_modulus_degree)
            self._galois_tool = GaloisTool(log_n)
        return self._galois_tool


class SealContext:
    """Validated parameter chain (reference: SEALContext, context.h:246-650)."""

    def __init__(
        self,
        parms: EncryptionParameters,
        expand_mod_chain: bool = True,
        sec_level: SecLevelType = SecLevelType.tc128,
    ):
        self._sec_level = sec_level
        self._context_data_map: Dict[ParmsId, ContextData] = {}

        parms = parms.clone()
        key_cd = self._validate(parms)
        self._context_data_map[parms.parms_id] = key_cd
        self.key_parms_id: ParmsId = parms.parms_id

        # First (data) level = key level minus one modulus
        # (context.cpp:477-489).
        if not key_cd.qualifiers.parameters_set() or len(parms.coeff_modulus) == 1:
            self.first_parms_id = self.key_parms_id
        else:
            next_id = self._create_next_context_data(self.key_parms_id)
            self.first_parms_id = (
                self.key_parms_id if next_id == PARMS_ID_ZERO else next_id
            )
        self.last_parms_id = self.first_parms_id
        self.using_keyswitching = self.first_parms_id != self.key_parms_id

        if expand_mod_chain and self._context_data_map[self.first_parms_id].qualifiers.parameters_set():
            prev_id = self.first_parms_id
            while len(self._context_data_map[prev_id].parms.coeff_modulus) > 1:
                next_id = self._create_next_context_data(prev_id)
                if next_id == PARMS_ID_ZERO:
                    break
                prev_id = next_id
                self.last_parms_id = next_id

        # chain_index: key level gets the highest index (context.cpp:514-522)
        count = len(self._context_data_map)
        cd: Optional[ContextData] = self._context_data_map[self.key_parms_id]
        while cd is not None:
            count -= 1
            cd.chain_index = count
            cd = cd.next_context_data

        # Fork (context.cpp:524-539): with nsp special primes the usable top
        # data level drops nsp-1 further steps.
        nsp = parms.n_special_primes
        if nsp > 1:
            if len(parms.coeff_modulus) <= nsp:
                raise ValueError("SealContext: #moduli <= n_special_primes")
            for _ in range(1, nsp):
                cd = self._context_data_map[self.first_parms_id]
                if cd.next_context_data is None:
                    raise RuntimeError("SealContext: cannot move first_parms_id")
                self.first_parms_id = cd.next_context_data.parms_id

    # -- accessors --------------------------------------------------------
    def get_context_data(self, parms_id: ParmsId) -> Optional[ContextData]:
        return self._context_data_map.get(tuple(parms_id))

    def key_context_data(self) -> ContextData:
        return self._context_data_map[self.key_parms_id]

    def first_context_data(self) -> ContextData:
        return self._context_data_map[self.first_parms_id]

    def last_context_data(self) -> ContextData:
        return self._context_data_map[self.last_parms_id]

    def parameters_set(self) -> bool:
        return self.first_context_data().qualifiers.parameters_set()

    @property
    def sec_level(self) -> SecLevelType:
        return self._sec_level

    # -- construction -----------------------------------------------------
    def _create_next_context_data(self, prev_id: ParmsId) -> ParmsId:
        prev = self._context_data_map[prev_id]
        next_parms = prev.parms.clone()
        coeff = next_parms.coeff_modulus
        coeff.pop()
        next_parms.set_coeff_modulus(coeff)
        next_cd = self._validate(next_parms)
        if not next_cd.qualifiers.parameters_set():
            return PARMS_ID_ZERO
        next_id = next_parms.parms_id
        self._context_data_map[next_id] = next_cd
        prev.next_context_data = next_cd
        next_cd.prev_context_data = prev
        return next_id

    def _validate(self, parms: EncryptionParameters) -> ContextData:
        """Mirror of SEALContext::validate (context.cpp:135-421)."""
        cd = ContextData(parms)
        q = cd.qualifiers
        q.parameter_error = ErrorType.success

        if parms.scheme == SchemeType.none:
            q.parameter_error = ErrorType.invalid_scheme
            return cd

        coeff_modulus = parms.coeff_modulus
        plain_modulus = parms.plain_modulus

        if not (COEFF_MOD_COUNT_MIN <= len(coeff_modulus) <= COEFF_MOD_COUNT_MAX):
            q.parameter_error = ErrorType.invalid_coeff_modulus_size
            return cd
        for m in coeff_modulus:
            if (
                m.value >> USER_MOD_BIT_COUNT_MAX
                or not m.value >> (USER_MOD_BIT_COUNT_MIN - 1)
            ):
                q.parameter_error = ErrorType.invalid_coeff_modulus_bit_count
                return cd

        cd.total_coeff_modulus = 1
        for m in coeff_modulus:
            cd.total_coeff_modulus *= m.value
        cd.total_coeff_modulus_bit_count = cd.total_coeff_modulus.bit_length()

        N = parms.poly_modulus_degree
        if not (POLY_MOD_DEGREE_MIN <= N <= POLY_MOD_DEGREE_MAX):
            q.parameter_error = ErrorType.invalid_poly_modulus_degree
            return cd
        log_n = numth.get_power_of_two(N)
        if log_n < 0:
            q.parameter_error = ErrorType.invalid_poly_modulus_degree_non_power_of_two
            return cd

        q.using_fft = True
        q.sec_level = self._sec_level
        if cd.total_coeff_modulus_bit_count > CoeffModulus.max_bit_count(N, self._sec_level):
            q.sec_level = SecLevelType.none
            if self._sec_level != SecLevelType.none:
                q.parameter_error = ErrorType.invalid_parameters_insecure
                return cd

        try:
            cd.rns_base = RNSBase(coeff_modulus)
        except ValueError:
            q.parameter_error = ErrorType.failed_creating_rns_base
            return cd

        q.using_ntt = True
        try:
            cd.ntt_tables = build_ntt_tables(log_n, coeff_modulus)
        except ValueError:
            q.using_ntt = False
            q.parameter_error = ErrorType.invalid_coeff_modulus_no_ntt
            return cd

        if parms.scheme == SchemeType.BFV:
            t = plain_modulus.value
            if t >> PLAIN_MOD_BIT_COUNT_MAX or not t >> (PLAIN_MOD_BIT_COUNT_MIN - 1):
                q.parameter_error = ErrorType.invalid_plain_modulus_bit_count
                return cd
            for m in coeff_modulus:
                if not numth.are_coprime(m.value, t):
                    q.parameter_error = ErrorType.invalid_plain_modulus_coprimality
                    return cd
            if t >= cd.total_coeff_modulus:
                q.parameter_error = ErrorType.invalid_plain_modulus_too_large
                return cd

            q.using_batching = True
            try:
                cd.plain_ntt_tables = build_ntt_tables(log_n, [plain_modulus])
            except ValueError:
                q.using_batching = False

            q.using_fast_plain_lift = all(m.value > t for m in coeff_modulus)

            # Delta = floor(q / t) and remainder, decomposed to RNS
            # (context.cpp:303-319).
            delta, rem = divmod(cd.total_coeff_modulus, t)
            cd.coeff_div_plain_modulus = np.array(
                cd.rns_base.decompose(delta), dtype=np.uint64
            )
            cd.coeff_modulus_mod_plain_modulus = rem
            cd.upper_half_increment = np.array(
                cd.rns_base.decompose(rem), dtype=np.uint64
            )
            cd.plain_upper_half_threshold = (t + 1) >> 1
            if q.using_fast_plain_lift:
                cd.plain_upper_half_increment = np.array(
                    [m.value - t for m in coeff_modulus], dtype=np.uint64
                )
            else:
                cd.plain_upper_half_increment = np.array(
                    cd.rns_base.decompose(cd.total_coeff_modulus - t),
                    dtype=np.uint64,
                )
        elif parms.scheme == SchemeType.CKKS:
            if plain_modulus.value != 0:
                q.parameter_error = ErrorType.invalid_plain_modulus_nonzero
                return cd
            q.using_batching = True
            q.using_fast_plain_lift = False
            cd.plain_upper_half_threshold = 1 << 63
            # (2^63 mod q_i) * (q_i - 2) mod q_i == -(2^64) mod q_i
            # (context.cpp:361-368).
            cd.plain_upper_half_increment = np.array(
                [
                    ((1 << 63) % m.value) * (m.value - 2) % m.value
                    for m in coeff_modulus
                ],
                dtype=np.uint64,
            )
            cd.upper_half_threshold = (cd.total_coeff_modulus + 1) >> 1
        else:
            q.parameter_error = ErrorType.invalid_scheme
            return cd

        try:
            cd.rns_tool = RNSTool(N, cd.rns_base, plain_modulus)
        except Exception:
            q.parameter_error = ErrorType.failed_creating_rns_tool
            return cd

        q.using_descending_modulus_chain = all(
            coeff_modulus[i].value > coeff_modulus[i + 1].value
            for i in range(len(coeff_modulus) - 1)
        )
        return cd
