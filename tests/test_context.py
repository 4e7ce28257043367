"""Context chain tests.

The pinned parms_id values were produced by the compiled reference
(SEALContext over BFVDefault(4096), PlainModulus::Batching(4096, 20)) —
bit-exact interop anchors.
"""

import pytest

from gemini_seal import (
    CoeffModulus,
    EncryptionParameters,
    Modulus,
    PlainModulus,
    SchemeType,
    SecLevelType,
)
from gemini_seal.context import ErrorType, SealContext


def bfv_parms_4096():
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(4096)
    parms.set_coeff_modulus(CoeffModulus.bfv_default(4096))
    parms.set_plain_modulus(PlainModulus.batching(4096, 20))
    return parms


def test_context_pinned_parms_ids():
    ctx = SealContext(bfv_parms_4096())
    assert ctx.parameters_set()
    assert ctx.key_parms_id == (
        0xD529462E17B0F051, 0xC057C2C7D402188F, 0x61F6DBDC01DE0D10, 0xBFF9017E62A404E0,
    )
    assert ctx.first_parms_id == (
        0x19FE3C41A79C7734, 0x9BA4584646042A04, 0x2F628BDDAAACBD4F, 0x0287B72AE1B99A4A,
    )
    key_cd = ctx.key_context_data()
    assert key_cd.chain_index == 2
    assert key_cd.total_coeff_modulus_bit_count == 109
    assert ctx.using_keyswitching


def test_chain_links():
    ctx = SealContext(bfv_parms_4096())
    cd = ctx.key_context_data()
    seen = 0
    while cd is not None:
        seen += 1
        if cd.next_context_data is not None:
            assert cd.next_context_data.prev_context_data is cd
            assert (
                len(cd.next_context_data.parms.coeff_modulus)
                == len(cd.parms.coeff_modulus) - 1
            )
        cd = cd.next_context_data
    assert seen == 3  # L=3 -> key + 2 data levels
    assert ctx.last_context_data().chain_index == 0


def test_qualifiers_flags():
    ctx = SealContext(bfv_parms_4096())
    q = ctx.key_context_data().qualifiers
    assert q.parameters_set()
    assert q.using_fft and q.using_ntt and q.using_batching
    assert q.sec_level == SecLevelType.tc128
    assert q.parameter_error_name == "success"
    assert q.parameter_error_message == "valid"


def test_insecure_rejected():
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(2048)
    parms.set_coeff_modulus(CoeffModulus.bfv_default(4096))  # too much q for N
    parms.set_plain_modulus(65537)
    ctx = SealContext(parms)
    cd = ctx.key_context_data()
    assert not cd.qualifiers.parameters_set()
    assert cd.qualifiers.parameter_error == ErrorType.invalid_parameters_insecure
    # with sec_level none the same parameters validate
    ctx2 = SealContext(parms, sec_level=SecLevelType.none)
    assert ctx2.parameters_set()


def test_tiny_insecure_context():
    # The reference's test style: N=64, sec_level none
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(64)
    parms.set_coeff_modulus(CoeffModulus.create(64, [40]))
    parms.set_plain_modulus(257)
    ctx = SealContext(parms, expand_mod_chain=False, sec_level=SecLevelType.none)
    assert ctx.parameters_set()
    assert not ctx.using_keyswitching  # single modulus
    cd = ctx.first_context_data()
    assert cd.coeff_div_plain_modulus is not None
    delta = cd.total_coeff_modulus // 257
    assert int(cd.coeff_div_plain_modulus[0]) == delta % cd.parms.coeff_modulus[0].value


def test_plain_modulus_not_coprime():
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(64)
    q = CoeffModulus.create(64, [40])
    parms.set_coeff_modulus(q)
    parms.set_plain_modulus(q[0].value)
    ctx = SealContext(parms, sec_level=SecLevelType.none)
    assert (
        ctx.key_context_data().qualifiers.parameter_error
        == ErrorType.invalid_plain_modulus_coprimality
    )


def test_ckks_context():
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(8192)
    parms.set_coeff_modulus(CoeffModulus.create(8192, [50, 40, 40, 50]))
    ctx = SealContext(parms)
    assert ctx.parameters_set()
    cd = ctx.first_context_data()
    assert cd.plain_upper_half_threshold == 1 << 63
    assert cd.upper_half_threshold == (cd.total_coeff_modulus + 1) >> 1
    # plain_upper_half_increment[i] == -(2^64) mod q_i
    for i, m in enumerate(cd.parms.coeff_modulus):
        assert int(cd.plain_upper_half_increment[i]) == (-(1 << 64)) % m.value


def test_n_special_primes_shift():
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(8192)
    parms.set_coeff_modulus(CoeffModulus.create(8192, [40, 30, 30, 40, 40]))
    parms.set_n_special_primes(2)
    ctx = SealContext(parms)
    # first level drops 1 (normal) + 1 (nsp-1) moduli below key level
    assert len(ctx.first_context_data().parms.coeff_modulus) == 3
    parms.set_n_special_primes(1)
    ctx1 = SealContext(parms)
    assert len(ctx1.first_context_data().parms.coeff_modulus) == 4


def test_rns_tool_constants():
    ctx = SealContext(bfv_parms_4096())
    cd = ctx.first_context_data()
    rt = cd.rns_tool
    q = cd.rns_base
    # inv_q_last_mod_q sanity
    q_last = q[q.size - 1].value
    for i in range(q.size - 1):
        assert (int(rt.inv_q_last_mod_q[i]) * q_last) % q[i].value == 1
    # Bsk coprime to q and m_tilde = 2^32
    assert rt.m_tilde.value == 1 << 32
    for m in rt.base_Bsk.base:
        for qm in q.base:
            assert m.value != qm.value
    # prod_B_mod_q
    for i, m in enumerate(q.base):
        assert int(rt.prod_B_mod_q[i]) == rt.base_B.base_prod % m.value


# ---------------------------------------------------------------------------
# Error taxonomy (reference: context.cpp:21-133, 15 error codes)
# ---------------------------------------------------------------------------

def _qualifier_error(parms, sec=SecLevelType.none):
    ctx = SealContext(parms, sec_level=sec)
    assert not ctx.parameters_set()
    return ctx.key_context_data().qualifiers.parameter_error


def test_error_invalid_poly_modulus_degree():
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(3)  # not a power of two
    parms.set_coeff_modulus([Modulus(65537)])
    parms.set_plain_modulus(17)
    assert _qualifier_error(parms) == ErrorType.invalid_poly_modulus_degree_non_power_of_two


def test_error_coeff_modulus_no_ntt():
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(64)
    # 1032193 = prime but != 1 mod 128? 1032193 % 128 == 1? pick 97: 97%128 != 1
    parms.set_coeff_modulus([Modulus(0x7FFFFFFF)])  # 2^31-1, not NTT-friendly
    parms.set_plain_modulus(17)
    assert _qualifier_error(parms) == ErrorType.invalid_coeff_modulus_no_ntt


def test_error_plain_modulus_too_large():
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(64)
    parms.set_coeff_modulus(CoeffModulus.create(64, [20]))
    parms.set_plain_modulus(PlainModulus.batching(64, 21).value)  # t > q
    err = _qualifier_error(parms)
    assert err != ErrorType.success
    assert "plain_modulus" in err.value[0]


def test_error_scheme_mismatch_plain_modulus():
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(64)
    parms.set_coeff_modulus(CoeffModulus.create(64, [40, 40]))
    # the setter itself rejects a nonzero t under CKKS (reference:
    # encryptionparams.h set_plain_modulus logic_error)
    with pytest.raises(ValueError):
        parms.set_plain_modulus(17)
