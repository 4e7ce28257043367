"""Jit-compiled evaluation pipelines ("the model zoo").

The reference exposes per-op C++ calls; on the device the unit of execution is a
fused XLA program.  This module builds jittable, batch-polymorphic step
functions over raw ciphertext tensors — the building blocks for benchmarks,
the graft entry points, and multi-chip sharded execution.  All per-level
constants close over the functions and compile into on-device executable
constants; keys are passed as arguments (they are large and shardable).

Batching: every step accepts ciphertext data shaped [..., size, L, N] with
any leading batch axes — ciphertext-batch data parallelism is a vmap-free
broadcast over those axes.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from ..context import SealContext
from ..ops import modops
from ..ops.dyadic import (add_poly, dyadic_product,
                          multiply_poly_scalar, sub_poly)
from ..ops.keyswitch import (KeySwitchPlan, batched_rotated_inner_product,
                             compute_modup_digits, fused_moddown,
                             keyswitch_inner_product, switch_key)
from ..ops.ntt import ntt_forward, ntt_forward_lazy, ntt_inverse
from ..ops.rnsops import (
    divide_and_round_q_last_ntt,
    fast_floor,
    fastbconv_m_tilde,
    fastbconv_sk,
    sm_mrq,
)

__all__ = [
    "build_ckks_mul_relin_rescale",
    "build_ckks_rotate",
    "build_ckks_rotate_many",
    "build_ckks_poly_eval",
    "build_ckks_matvec",
    "build_ckks_matvec_bsgs",
    "build_ckks_dense_layer",
    "build_ckks_conv2d",
    "build_ckks_conv2d_mc",
    "strided_dense_diagonals",
    "build_ckks_logreg",
    "build_ckks_logreg_train_step",
    "build_ckks_cnn",
    "build_bfv_mul_relin",
    "build_bfv_mul_relin_modswitch",
    "build_bfv_rotate_many",
    "build_bfv_matvec",
    "prepermute_galois_stack",
    "build_ckks_mlp",
    "build_ckks_matmul_square",
    "build_ckks_attention",
    "attention_plan",
    "build_ckks_inverse",
    "build_ckks_rsqrt",
    "build_ckks_sqrt",
    "build_ckks_sign",
    "build_ckks_relu",
    "build_ckks_max",
    "sign_composite_reference",
    "build_ckks_train_step",
]


def _convolve3(a, b, limbs):
    """Size-2 x size-2 ciphertext product -> 3 components, batched.

    a, b: [..., 2, L, N].
    """
    a0, a1 = a[..., 0, :, :], a[..., 1, :, :]
    b0, b1 = b[..., 0, :, :], b[..., 1, :, :]
    c0 = dyadic_product(a0, b0, limbs)
    c1 = add_poly(
        dyadic_product(a0, b1, limbs), dyadic_product(a1, b0, limbs), limbs
    )
    c2 = dyadic_product(a1, b1, limbs)
    return c0, c1, c2


def _square3(a, limbs):
    """Size-2 ciphertext square -> 3 components, batched: 3 dyadic products
    instead of _convolve3's 4 (reference: evaluator.cpp:659-676); bit-exact
    with _convolve3(a, a).

    a: [..., 2, L, N].
    """
    a0, a1 = a[..., 0, :, :], a[..., 1, :, :]
    cross = dyadic_product(a0, a1, limbs)
    c0 = dyadic_product(a0, a0, limbs)
    c1 = add_poly(cross, cross, limbs)
    c2 = dyadic_product(a1, a1, limbs)
    return c0, c1, c2


def _relinearize_batched(c0, c1, c2, key_data, plan, limbs, is_ntt: bool):
    """Fold the c2 component back to (c0, c1) via hybrid key switch.

    switch_key operates on [..., L, N] targets (batch axes broadcast).
    """
    d0, d1 = switch_key(c2, key_data, plan, is_ntt)
    return add_poly(c0, d0, limbs), add_poly(c1, d1, limbs)


def build_ckks_mul_relin_rescale(context: SealContext, parms_id=None,
                                 fused: bool = False,
                                 square: bool = False) -> Callable:
    """fn(ct_a, ct_b, relin_key) -> next-level ciphertext data.

    ct_*: u64[..., 2, L, N] (NTT form); relin_key: u64[n_bundles, 2, L_key, N].
    Returns u64[..., 2, L-1, N].  This is benchmark config 4/5's hot step
    (multiply + relinearize + rescale).

    fused=True merges the rescale into the key-switch mod-down (one division
    by P*q_last instead of two sequential roundings): one NTT round trip per
    component saved; decrypts equal but not bit-identical to the sequential
    path (see ops.keyswitch.fused_moddown).

    square=True returns fn(ct, relin_key) using the 3-product square
    convolution (bit-exact with the multiply path on identical operands;
    reference: evaluator.cpp:708-770 ckks_square).
    """
    if parms_id is None:
        parms_id = context.first_parms_id
    cd = context.get_context_data(parms_id)
    limbs = cd.limb_constants
    tables = cd.ntt_tables
    tool = cd.device_rns_tool
    plan = KeySwitchPlan(context, parms_id)

    def product(a, b):
        return _square3(a, limbs) if square else _convolve3(a, b, limbs)

    if fused:
        plan.fused_drop_constants()  # precompute on host, outside the trace

        def step_fused(a, b, relin_key):
            c0, c1, c2 = product(a, b)
            ct_k = compute_modup_digits(c2, plan, True)
            acc0, acc1 = keyswitch_inner_product(
                ct_k, relin_key, plan, True, raw=True
            )
            out0 = fused_moddown(c0, acc0, plan)
            out1 = fused_moddown(c1, acc1, plan)
            return jnp.stack([out0, out1], axis=-3)

        if square:
            return lambda a, relin_key: step_fused(a, a, relin_key)
        return step_fused

    def step(a, b, relin_key):
        c0, c1, c2 = product(a, b)
        c0, c1 = _relinearize_batched(c0, c1, c2, relin_key, plan, limbs, True)
        ct = jnp.stack([c0, c1], axis=-3)
        return divide_and_round_q_last_ntt(ct, tool, tables)

    if square:
        return lambda a, relin_key: step(a, a, relin_key)
    return step


def build_ckks_rotate(context: SealContext, steps: int, parms_id=None) -> Callable:
    """fn(ct, galois_key) -> rotated ciphertext data (same level)."""
    if parms_id is None:
        parms_id = context.first_parms_id
    cd = context.get_context_data(parms_id)
    limbs = cd.limb_constants
    tool = cd.galois_tool
    elt = tool.get_elt_from_step(steps)
    plan = KeySwitchPlan(context, parms_id)

    def step(ct, galois_key):
        c0 = tool.apply_galois_ntt(ct[..., 0, :, :], elt)
        c1 = tool.apply_galois_ntt(ct[..., 1, :, :], elt)
        d0, d1 = switch_key(c1, galois_key, plan, True)
        return jnp.stack([add_poly(c0, d0, limbs), d1], axis=-3)

    return step


def build_bfv_mul_relin(context: SealContext, parms_id=None,
                        square: bool = False) -> Callable:
    """fn(ct_a, ct_b, relin_key) -> size-2 ciphertext data (BFV, BEHZ).

    Benchmark config 1/3's hot step.

    square=True returns fn(ct, relin_key): ONE base extension + NTT lift
    (multiply runs them per operand) and the 3-product square convolution
    (reference: evaluator.cpp:560-706 bfv_square); bit-exact with the
    multiply path on identical operands.
    """
    if parms_id is None:
        parms_id = context.first_parms_id
    cd = context.get_context_data(parms_id)
    parms = cd.parms
    limbs = cd.limb_constants
    tool = cd.device_rns_tool
    bsk_limbs = tool.Bsk_limbs
    t = jnp.uint64(parms.plain_modulus.value)
    plan = KeySwitchPlan(context, parms_id)

    def extend(ct):
        # lazy [0, 4p) lifts into the convolution's full-range Barrett
        # dyadic products — bit-identical to the canonical path
        q_ntt = ntt_forward_lazy(ct, cd.ntt_tables)
        lifted = fastbconv_m_tilde(ct, tool)
        bsk = sm_mrq(lifted, tool)
        bsk_ntt = ntt_forward_lazy(bsk, tool.base_Bsk_ntt_tables)
        return q_ntt, bsk_ntt

    def step(a, b, relin_key):
        aq, absk = extend(a)
        if square:
            dq = _square3(aq, limbs)
            dbsk = _square3(absk, bsk_limbs)
        else:
            bq, bbsk = extend(b)
            dq = _convolve3(aq, bq, limbs)
            dbsk = _convolve3(absk, bbsk, bsk_limbs)
        out = []
        for k in range(3):
            q_part = ntt_inverse(dq[k], cd.ntt_tables)
            bsk_part = ntt_inverse(dbsk[k], tool.base_Bsk_ntt_tables)
            tq = multiply_poly_scalar(q_part, t, limbs)
            tbsk = modops.mul_mod(
                bsk_part, t, bsk_limbs.p, bsk_limbs.ratio0, bsk_limbs.ratio1
            )
            out.append(fastbconv_sk(fast_floor(tq, tbsk, tool), tool))
        c0, c1 = _relinearize_batched(out[0], out[1], out[2], relin_key, plan, limbs, False)
        return jnp.stack([c0, c1], axis=-3)

    if square:
        return lambda a, relin_key: step(a, a, relin_key)
    return step


def build_bfv_mul_relin_modswitch(context: SealContext, target_parms_id=None,
                                  fused_drop: bool = True,
                                  square: bool = False) -> Callable:
    """BFV multiply + relinearize + mod-switch down to `target_parms_id`
    (default: the chain's last level) as ONE jittable program — benchmark
    config 3's full step (reference composes evaluator.cpp:274-445 +
    829-994 eagerly per level).

    fused_drop=True uses the single rounded division by the product of all
    dropped primes (ops/rnsops.MultiDropPlan) when >= 2 levels are dropped —
    one CRT interpolation instead of a per-level chain (decrypts equal,
    bounded sub-noise rounding difference; noise pinned by tests/test_noise
    .test_multi_drop_noise_cost).  fused_drop=False chains the exact
    per-level divide_and_round_q_last (bit-exact vs the host evaluator).
    """
    from ..ops.rnsops import MultiDropPlan, divide_and_round_multi, \
        divide_and_round_q_last

    first_id = context.first_parms_id
    if target_parms_id is None:
        target_parms_id = context.last_parms_id
    first_cd = context.get_context_data(first_id)
    target_cd = context.get_context_data(target_parms_id)
    levels = first_cd.chain_index - target_cd.chain_index
    mul = build_bfv_mul_relin(context, first_id, square=square)

    if fused_drop and levels >= 2:
        plan = MultiDropPlan(context, first_id, levels)

        def drop(y):
            return divide_and_round_multi(y, plan)
    else:
        cds = []
        cd = first_cd
        for _ in range(levels):
            cds.append(cd)
            cd = cd.next_context_data

        def drop(y):
            for cd in cds:
                y = divide_and_round_q_last(y, cd.device_rns_tool)
            return y

    if square:
        return lambda a, relin_key: drop(mul(a, relin_key))
    return lambda a, b, relin_key: drop(mul(a, b, relin_key))


def prepermute_galois_stack(tool, elts, keys_stack):
    """Counter-rotate a stacked Galois key set by each element's INVERSE
    NTT permutation (host numpy, build time).

    The hoisting lemma behind it: the Galois automorphism pi is a pure
    coefficient permutation in NTT domain, so for the key-switch
    contraction  sum_b pi(D_b(c1)) * k_b  =  pi( sum_b D_b(c1) *
    pi^{-1}(k_b) ):  with pi^{-1} baked into the keys at build time, the
    mod-up digits are contracted SHARED AND UNPERMUTED across every
    rotation, and ONE signed permutation of the final [2, L, N] output
    replaces the per-rotation nb*n_ext-row digit gather (the dominant
    per-rotation memory traffic in the round-3 hoisted kernel, which
    measured ~1.0x over sequential at config 2').

    keys_stack: u64[R, n_bundles, 2, L_key, N] in elts order.
    """
    import numpy as np

    out = np.empty_like(np.asarray(keys_stack))
    for i, e in enumerate(elts):
        tab = tool._ntt_table(e)
        itab = np.empty_like(tab)
        itab[tab] = np.arange(tab.shape[-1], dtype=tab.dtype)
        out[i] = np.take(np.asarray(keys_stack)[i], itab, axis=-1)
    return out


def _shared_digit_inner_product(ct_k, keys_stack, plan):
    """Key-switch contraction with the rotation axis living ONLY on the
    (pre-permuted) keys: digits broadcast over R — no per-rotation digit
    permutation (see prepermute_galois_stack).

    ct_k: [..., nb, n_ext, N]; keys_stack: u64[R, nb, 2, L_key, N]
    (counter-rotated).  Returns (a0, a1): [..., R, n_ext, N].
    """
    keys_ext = keys_stack[..., plan.ext_key_indices, :]
    ext = plan.ext_limbs
    nb = plan.n_bundles
    a0 = modops.accumulate_mulmod_128(
        ((ct_k[..., None, b, :, :], keys_ext[:, b, 0]) for b in range(nb)),
        ext.p, ext.ratio0, ext.ratio1)
    a1 = modops.accumulate_mulmod_128(
        ((ct_k[..., None, b, :, :], keys_ext[:, b, 1]) for b in range(nb)),
        ext.p, ext.ratio0, ext.ratio1)
    return a0, a1


def build_bfv_rotate_many(context: SealContext, steps, parms_id=None,
                          prepermuted_keys: bool = False) -> Callable:
    """fn(ct, galois_keys_stack) -> [n_steps, ..., 2, L, N]: hoisted BFV
    row rotations — ONE mod-up digit decomposition (power-basis dataflow)
    feeds every step's key-switch inner product (benchmark config 2's
    hoisted variant; mirrors build_ckks_rotate_many).

    prepermuted_keys=True: galois_keys_stack must be counter-rotated with
    prepermute_galois_stack.  The digits are then contracted shared and
    unpermuted; the whole rotation happens as ONE signed coeff-domain
    permutation of the finished [2, L, N] output per step (automorphisms
    commute with the key-switch as ring maps).  The fast base conversion
    inside the special-prime mod-down is not odd-symmetric (negated
    representatives shift its bounded lift error by <= nsp), so outputs
    DECRYPT EQUAL to the default path but are not bit-identical — the
    same bounded-rounding argument as ops.keyswitch.fused_moddown."""
    import numpy as np

    if parms_id is None:
        parms_id = context.first_parms_id
    cd = context.get_context_data(parms_id)
    limbs = cd.limb_constants
    tool = cd.galois_tool
    elts = tool.get_elts_from_steps(list(steps))
    plan = KeySwitchPlan(context, parms_id)

    from ..ops.keyswitch import rescale_special

    # Stacked permutation tables: all rotations ride ONE gather and one
    # batched 128-bit contraction (batched_rotated_inner_product) — the
    # per-step loop compiles pathologically at deep L (PERF.md).
    rot_tabs = np.stack([tool._ntt_table(e) for e in elts])
    coeff_srcs = np.stack([tool._coeff_table(e)[0] for e in elts])
    coeff_negs = np.stack([tool._coeff_table(e)[1] for e in elts])[:, None, :]

    if prepermuted_keys:
        srcs4 = jnp.asarray(coeff_srcs)[:, None, None, :]  # [R, 1, 1, N]
        negs4 = jnp.asarray(
            np.stack([tool._coeff_table(e)[1] for e in elts])
        )[:, None, None, :]

        def step_pk(ct, keys_stack):
            c0 = ct[..., 0, :, :]
            c1 = ct[..., 1, :, :]
            ct_k = compute_modup_digits(c1, plan, False)   # hoisted
            a0, a1 = _shared_digit_inner_product(ct_k, keys_stack, plan)
            d0 = rescale_special(a0, plan, is_ntt_output=False)
            d1 = rescale_special(a1, plan, is_ntt_output=False)
            x0 = add_poly(c0[..., None, :, :], d0, limbs)  # [..., R, L, N]
            x = jnp.stack([x0, d1], axis=-3)               # [..., R, 2, L, N]
            idx = srcs4.reshape((1,) * (x.ndim - 4) + srcs4.shape)
            g = jnp.take_along_axis(x, idx, axis=-1)
            out = jnp.where(negs4, modops.neg_mod(g, limbs.p), g)
            return jnp.moveaxis(out, -4, 0)                # [R, ..., 2, L, N]

        return step_pk

    def step(ct, keys_stack):
        c0 = ct[..., 0, :, :]
        c1 = ct[..., 1, :, :]
        ct_k = compute_modup_digits(c1, plan, False)       # hoisted
        a0, a1 = batched_rotated_inner_product(ct_k, rot_tabs, keys_stack,
                                               plan)       # [..., R, n_ext, N]
        d0 = rescale_special(a0, plan, is_ntt_output=False)
        d1 = rescale_special(a1, plan, is_ntt_output=False)
        g = jnp.moveaxis(jnp.take(c0, jnp.asarray(coeff_srcs), axis=-1),
                         -2, -3)                           # [..., R, L, N]
        p0 = jnp.where(jnp.asarray(coeff_negs),
                       modops.neg_mod(g, limbs.p), g)
        out = jnp.stack([add_poly(p0, d0, limbs), d1], axis=-3)
        return jnp.moveaxis(out, -4, 0)                    # [R, ..., 2, L, N]

    return step


def build_ckks_train_step(context: SealContext, rotate_steps: int = 1) -> Callable:
    """The flagship composite step: multiply + relinearize + rescale +
    rotate + add — the inner loop of encrypted dot-product / polynomial
    evaluation workloads (benchmark config 5).

    fn(ct_a, ct_b, relin_key, galois_key) -> u64[..., 2, L-1, N].
    """
    parms_id = context.first_parms_id
    mul_step = build_ckks_mul_relin_rescale(context, parms_id)
    next_id = context.get_context_data(parms_id).next_context_data.parms_id
    rot_step = build_ckks_rotate(context, rotate_steps, next_id)
    cd_next = context.get_context_data(next_id)
    limbs = cd_next.limb_constants

    def step(a, b, relin_key, galois_key):
        prod = mul_step(a, b, relin_key)
        rot = rot_step(prod, galois_key)
        return add_poly(prod, rot, limbs)

    return step


def build_ckks_rotate_many(context: SealContext, steps, parms_id=None,
                           prepermuted_keys: bool = False) -> Callable:
    """fn(ct, galois_keys_stack) -> [n_steps, ..., 2, L, N] rotated batch.

    Hoisted rotations: one mod-up digit decomposition feeds every step's
    key-switch inner product (no reference analogue; the rotation-heavy
    inner loop of encrypted matrix-vector / convolution workloads).
    galois_keys_stack: u64[n_steps, n_bundles, 2, L_key, N] — key(elt_i) for
    each step, in order.

    prepermuted_keys=True: the stack must be counter-rotated with
    prepermute_galois_stack; digits are contracted shared and unpermuted
    and ONE NTT-domain permutation of the finished [2, L, N] output per
    step replaces the per-rotation nb*n_ext-row digit gather.  Decrypts
    equal to the default path, not bit-identical (the special-prime
    mod-down's base-conversion lift is not odd-symmetric — same bounded
    argument as ops.keyswitch.fused_moddown).
    """
    import numpy as np

    if parms_id is None:
        parms_id = context.first_parms_id
    cd = context.get_context_data(parms_id)
    limbs = cd.limb_constants
    tool = cd.galois_tool
    elts = tool.get_elts_from_steps(list(steps))
    plan = KeySwitchPlan(context, parms_id)

    from ..ops.keyswitch import rescale_special

    # Stacked NTT permutation tables: all rotations ride ONE gather and
    # one batched 128-bit contraction (batched_rotated_inner_product) —
    # the per-step loop compiles pathologically at deep L (PERF.md).
    rot_tabs = np.stack([tool._ntt_table(e) for e in elts])

    if prepermuted_keys:
        tabs4 = jnp.asarray(rot_tabs)[:, None, None, :]    # [R, 1, 1, N]

        def step_pk(ct, keys_stack):
            c0 = ct[..., 0, :, :]
            c1 = ct[..., 1, :, :]
            ct_k = compute_modup_digits(c1, plan, True)    # hoisted
            a0, a1 = _shared_digit_inner_product(ct_k, keys_stack, plan)
            d0 = rescale_special(a0, plan, is_ntt_output=True)
            d1 = rescale_special(a1, plan, is_ntt_output=True)
            x0 = add_poly(c0[..., None, :, :], d0, limbs)  # [..., R, L, N]
            x = jnp.stack([x0, d1], axis=-3)               # [..., R, 2, L, N]
            idx = tabs4.reshape((1,) * (x.ndim - 4) + tabs4.shape)
            out = jnp.take_along_axis(x, idx, axis=-1)
            return jnp.moveaxis(out, -4, 0)                # [R, ..., 2, L, N]

        return step_pk

    def step(ct, keys_stack):
        c0 = ct[..., 0, :, :]
        c1 = ct[..., 1, :, :]
        ct_k = compute_modup_digits(c1, plan, True)        # hoisted
        a0, a1 = batched_rotated_inner_product(ct_k, rot_tabs, keys_stack,
                                               plan)       # [..., R, n_ext, N]
        d0 = rescale_special(a0, plan, is_ntt_output=True)
        d1 = rescale_special(a1, plan, is_ntt_output=True)
        p0 = jnp.moveaxis(jnp.take(c0, jnp.asarray(rot_tabs), axis=-1),
                          -2, -3)
        out = jnp.stack([add_poly(p0, d0, limbs), d1], axis=-3)
        return jnp.moveaxis(out, -4, 0)                    # [R, ..., 2, L, N]

    return step


def build_ckks_poly_eval(context: SealContext, coeffs, scale: float,
                         encoder, rotate_sum_log2: int = 0,
                         coeff_precision_bits: int = 30,
                         fused: bool = False,
                         composed: bool = False,
                         rotate_mode: str = "tree",
                         parms_id=None):
    """Deep encrypted polynomial evaluation (BASELINE config 5).

    Computes p(x) = sum_k coeffs[k] * x^k over len(coeffs)-2 multiplicative
    levels: a sequential power chain (each step multiply + relinearize +
    rescale; the first step is the 3-product SQUARE), then the plaintext
    linear combination at the deepest level with per-term scale alignment,
    optionally followed by a log-tree of rotations summing
    2^rotate_sum_log2 adjacent slots.

    composed=False returns one jittable step — a single deep XLA graph
    (minutes of one-time compile at N=32768).  composed=True returns an
    already-compiled PYTHON callable chaining one jitted program per level
    plus one combine program: each sub-program compiles in seconds and the
    ~0.74 ms/dispatch overhead is negligible against the per-level compute
    (PERF.md "compile-time note" prescription).  Outputs are bit-identical
    between the two modes.

    rotate_mode selects the rotation-sum dataflow:
    - "tree" (default): log2 doubling tree — rotate_sum_log2 sequential
      full key switches with power-of-two step keys (bit-exact with the
      host evaluator's rotate/add chain).
    - "flat": ONE hoisted mod-up feeds 2^m - 1 raw inner products whose
      accumulators are summed and special-prime mod-downed ONCE — m
      mod-ups/mod-downs collapse to one of each at the cost of
      2^m - 1 (cheap) inner products.  Needs keys for EVERY step
      1..2^m-1, stack ordered by step; decrypt-equal to "tree" within
      sub-noise rounding (raw-accumulator fusion, cf. build_ckks_matvec).

    Returns (step, out_parms_id, out_scale):
    step(x_data, relin_key, galois_keys_stack) -> u64[..., 2, L_deep, N].
    x_data: fresh ciphertext of x at `scale`; galois_keys_stack:
    u64[n_keys, n_bundles, 2, L_key, N] with n_keys = rotate_sum_log2
    ("tree") or 2^rotate_sum_log2 - 1 ("flat"); pass a zero-size array
    when rotate_sum_log2 == 0.
    """
    import numpy as np

    degree = len(coeffs) - 1
    if degree < 2:
        raise ValueError("need a polynomial of degree >= 2")
    n_levels = degree - 1              # multiplies in the power chain
    ids = [parms_id if parms_id is not None else context.first_parms_id]
    while len(ids) < n_levels + 1:
        nxt = context.get_context_data(ids[-1]).next_context_data
        if nxt is None:
            raise ValueError("modulus chain too short for this degree")
        ids.append(nxt.parms_id)
    deep_id = ids[n_levels]
    deep_cd = context.get_context_data(deep_id)
    deep_limbs = deep_cd.limb_constants
    L_deep = len(deep_cd.parms.coeff_modulus)

    muls = [build_ckks_mul_relin_rescale(context, ids[k], fused=fused,
                                         square=(k == 0))
            for k in range(n_levels)]

    # scale of x^k after the chain + mod-switch-down to the deepest level
    power_scales = [None, float(scale)]
    for k in range(n_levels):
        q_last = context.get_context_data(ids[k]).parms.coeff_modulus[-1].value
        power_scales.append(power_scales[-1] * scale / q_last)

    # plaintext multipliers aligned to one common output scale
    target_scale = float(scale) * (2.0 ** coeff_precision_bits)
    plains = []
    for k in range(1, degree + 1):
        pl = encoder.encode(coeffs[k], target_scale / power_scales[k], deep_id)
        plains.append(np.asarray(pl.data))
    const_plain = np.asarray(encoder.encode(coeffs[0], target_scale, deep_id).data)

    rot_plan = KeySwitchPlan(context, deep_id) if rotate_sum_log2 else None
    if rotate_sum_log2 and rotate_mode == "flat":
        # Stacked NTT permutation tables: the 2^m - 1 rotations ride ONE
        # gather + one batched 128-bit contraction (see build_ckks_matvec's
        # compile-time note in PERF.md) instead of a per-step unrolled loop.
        flat_elts = [deep_cd.galois_tool.get_elt_from_step(s)
                     for s in range(1, 1 << rotate_sum_log2)]
        flat_tabs = np.stack(
            [deep_cd.galois_tool._ntt_table(e) for e in flat_elts])

    def level_step(k, prev, x, relin_key):
        """One power-chain level: x^(k+1) -> x^(k+2) (k=0 is the square)."""
        if k == 0:
            return muls[0](prev, relin_key)
        L_k = len(context.get_context_data(ids[k]).parms.coeff_modulus)
        return muls[k](prev, x[..., :L_k, :], relin_key)

    def combine(powers, galois_keys_stack):
        """Plaintext linear combination at the deepest level + rotation tree."""
        acc_c0 = const_plain
        acc = None
        for k in range(1, degree + 1):
            pk = powers[k - 1][..., :L_deep, :]        # mod-switch-drop
            term = dyadic_product(pk, plains[k - 1], deep_limbs)
            acc = term if acc is None else add_poly(acc, term, deep_limbs)
        c0 = add_poly(acc[..., 0, :, :], acc_c0, deep_limbs)
        r = jnp.concatenate([c0[..., None, :, :], acc[..., 1:, :, :]], axis=-3)
        if rotate_sum_log2 and rotate_mode == "flat":
            from ..ops.keyswitch import rescale_special

            ext = rot_plan.ext_limbs
            R = len(flat_elts)
            c0r, c1r = r[..., 0, :, :], r[..., 1, :, :]
            ct_k = compute_modup_digits(c1r, rot_plan, True)  # hoisted once
            # one gather + one contraction for all rotations; the reduced
            # per-rotation accumulators then fold over R with modular adds
            # (the raw-sum fusion: ONE special-prime mod-down for all R)
            a0, a1 = batched_rotated_inner_product(
                ct_k, flat_tabs, galois_keys_stack, rot_plan)
            raw0, raw1 = a0[..., 0, :, :], a1[..., 0, :, :]
            for i in range(1, R):
                raw0 = add_poly(raw0, a0[..., i, :, :], ext)
                raw1 = add_poly(raw1, a1[..., i, :, :], ext)
            c0_rot = jnp.take(c0r, jnp.asarray(flat_tabs), axis=-1)
            c0_acc = c0r
            for i in range(R):
                c0_acc = add_poly(c0_acc, c0_rot[..., i, :], deep_limbs)
            d0 = rescale_special(raw0, rot_plan, is_ntt_output=True)
            d1 = rescale_special(raw1, rot_plan, is_ntt_output=True)
            r = jnp.stack([
                add_poly(c0_acc, d0, deep_limbs),
                add_poly(c1r, d1, deep_limbs),
            ], axis=-3)
        elif rotate_sum_log2:
            tool = deep_cd.galois_tool
            for i in range(rotate_sum_log2):
                elt = tool.get_elt_from_step(1 << i)
                rc0 = tool.apply_galois_ntt(r[..., 0, :, :], elt)
                rc1 = tool.apply_galois_ntt(r[..., 1, :, :], elt)
                d0, d1 = switch_key(rc1, galois_keys_stack[i], rot_plan, True)
                rot = jnp.stack([add_poly(rc0, d0, deep_limbs), d1], axis=-3)
                r = add_poly(r, rot, deep_limbs)
        return r

    if composed:
        import jax

        level_jits = [
            jax.jit(lambda prev, x, rk, k=k: level_step(k, prev, x, rk))
            for k in range(n_levels)
        ]
        combine_jit = jax.jit(combine)

        def run(x, relin_key, galois_keys_stack):
            powers = [x]
            for k in range(n_levels):
                powers.append(level_jits[k](powers[-1], x, relin_key))
            return combine_jit(powers, galois_keys_stack)

        return run, deep_id, target_scale

    def step(x, relin_key, galois_keys_stack):
        # power chain: powers[k] = x^(k+1) data at level k (scale chain above)
        powers = [x]
        for k in range(n_levels):
            powers.append(level_step(k, powers[-1], x, relin_key))
        return combine(powers, galois_keys_stack)

    return step, deep_id, target_scale


def build_ckks_matvec(context: SealContext, diagonals, scale: float,
                      encoder, parms_id=None, fuse_moddown: bool = True) -> Callable:
    """Encrypted matrix-vector product by the diagonal method with HOISTED
    rotations: y = sum_d diag_d (*) rot(x, d) — one key-switch mod-up feeds
    every rotation (the inner loop of encrypted linear layers / LR or
    dense-NN inference; no reference analogue).

    fuse_moddown (default): the k rotations' RAW key-switch accumulators
    are multiplied by extended-base diagonal encodings and SUMMED, then
    special-prime mod-downed ONCE — k-1 fewer rescale_special passes
    (each an nsp-row inverse + n_ct-row forward NTT per component).  The
    single interpolation rounding differs from the k sequential ones by
    a bounded sub-noise amount (same argument as ops.keyswitch.
    fused_moddown), so results decrypt equal but are not bit-identical
    to fuse_moddown=False.

    diagonals: {step d: list of slot values} for the nonzero generalized
    diagonals M[i, (i+d) % cols]; step 0 needs no rotation key.
    Returns fn(ct, galois_keys_stack) -> u64[..., 2, L, N] at the SAME level
    with scale*scale (rescale separately or feed a fused consumer).
    galois_keys_stack: u64[n_nonzero_steps, n_bundles, 2, L_key, N] ordered
    by sorted nonzero steps.
    """
    if parms_id is None:
        parms_id = context.first_parms_id
    cd = context.get_context_data(parms_id)
    limbs = cd.limb_constants
    tool = cd.galois_tool
    plan = KeySwitchPlan(context, parms_id)

    import numpy as np

    steps = sorted(diagonals.keys())
    rot_steps = [s for s in steps if s != 0]
    elts = [tool.get_elt_from_step(s) for s in rot_steps]
    plains = {
        s: np.asarray(encoder.encode(list(diagonals[s]), scale, parms_id).data)
        for s in steps
    }
    if fuse_moddown and rot_steps:
        from ..modulus import Modulus
        from ..ops.keyswitch import rescale_special

        ext_mods = [Modulus(p) for p in plan.ext_moduli]
        plains_ext = {
            s: encoder.encode_at_base(
                list(diagonals[s]), scale, parms_id, ext_mods, plan.ext_tables
            )
            for s in rot_steps
        }
        ext_limbs = plan.ext_limbs

    # Stacked constants + permutation tables: every rotation is one row of
    # a single gather, every diagonal product one slice of a single 128-bit
    # contraction (see build_ckks_matvec_bsgs.step for the graph-size
    # rationale — the unbatched form compiles pathologically at deep L).
    R = len(rot_steps)
    rot_tabs = (np.stack([tool._ntt_table(e) for e in elts]) if R else None)
    ptc_rot = (np.stack([plains[s] for s in rot_steps]) if R else None)
    if fuse_moddown and rot_steps:
        pte_rot = np.stack([plains_ext[s] for s in rot_steps])

    def step(ct, galois_keys_stack):
        c0 = ct[..., 0, :, :]
        c1 = ct[..., 1, :, :]
        acc = None
        if 0 in plains:
            t0 = dyadic_product(c0, plains[0], limbs)
            t1 = dyadic_product(c1, plains[0], limbs)
            acc = jnp.stack([t0, t1], axis=-3)
        if rot_steps:
            ct_k = compute_modup_digits(c1, plan, True)   # hoisted once
            a0, a1 = batched_rotated_inner_product(
                ct_k, rot_tabs, galois_keys_stack, plan)  # [..., R, n_ext, N]
            rc = jnp.moveaxis(jnp.take(c0, jnp.asarray(rot_tabs), axis=-1),
                              -2, -3)
        if rot_steps and fuse_moddown:
            pte = jnp.asarray(pte_rot)
            raw0 = modops.accumulate_mulmod_128(
                ((a0[..., r, :, :], pte[r]) for r in range(R)),
                ext_limbs.p, ext_limbs.ratio0, ext_limbs.ratio1)
            raw1 = modops.accumulate_mulmod_128(
                ((a1[..., r, :, :], pte[r]) for r in range(R)),
                ext_limbs.p, ext_limbs.ratio0, ext_limbs.ratio1)
            ptcj = jnp.asarray(ptc_rot)
            ct_part = modops.accumulate_mulmod_128(
                ((rc[..., r, :, :], ptcj[r]) for r in range(R)),
                limbs.p, limbs.ratio0, limbs.ratio1)
            d0 = rescale_special(raw0, plan, is_ntt_output=True)
            d1 = rescale_special(raw1, plan, is_ntt_output=True)
            term = jnp.stack([add_poly(ct_part, d0, limbs), d1], axis=-3)
            acc = term if acc is None else add_poly(acc, term, limbs)
        elif rot_steps:
            from ..ops.keyswitch import rescale_special as _rs

            d0 = _rs(a0, plan, is_ntt_output=True)        # [..., R, L, N]
            d1 = _rs(a1, plan, is_ntt_output=True)
            ptcj = jnp.asarray(ptc_rot)
            t0 = dyadic_product(add_poly(rc, d0, limbs), ptcj, limbs)
            t1 = dyadic_product(d1, ptcj, limbs)
            for r in range(R):
                term = jnp.stack([t0[..., r, :, :], t1[..., r, :, :]],
                                 axis=-3)
                acc = term if acc is None else add_poly(acc, term, limbs)
        return acc

    return step


def build_ckks_matvec_bsgs(context: SealContext, diagonals, scale: float,
                           encoder, parms_id=None, baby: int = None):
    """Baby-step/giant-step encrypted matvec (Halevi-Shoup): k generalized
    diagonals cost B-1 baby + G-1 giant key-switch inner products instead
    of k-1, with B*G >= k and B ~ sqrt(k) — the standard rotation-count
    reduction for LARGE encrypted linear layers (no reference analogue;
    the reference stops at per-op rotations, evaluator.cpp:1945-2000).

    Identity: diag_d (*) rot(x, d) = rot(rot(diag_d, -gB) (*) rot(x, b), gB)
    for d = gB + b, so the matvec regroups as
        y = sum_g rot_{gB}( S_g ),   S_g = sum_b diag'_{g,b} (*) rot_b(x).
    Schedule: ONE hoisted mod-up feeds every baby rotation's raw
    inner-product accumulator; each S_g (g>=1) is materialized with its
    own special-prime mod-down, giant-rotated, and its key-switch raws are
    summed with S_0's raws for ONE final mod-down (same bounded
    interpolation-rounding argument as ops.keyswitch.fused_moddown — the
    result decrypts equal to, but is not bit-identical with, the
    rotation-by-rotation path).

    diagonals: {step d: slot values} (negative steps normalize to
    slots + d — the same cyclic rotation; groups are presence-based, so
    clustered step sets stay cheap); baby: B (default ~sqrt(#steps)).
    Returns (fn, rot_steps): fn(ct, galois_keys_stack) -> u64[..., 2, L, N]
    at the SAME level with scale*scale; galois_keys_stack stacked in
    `rot_steps` order (baby steps then giant steps).
    """
    import numpy as np

    from ..modulus import Modulus
    from ..ops.keyswitch import rescale_special

    if parms_id is None:
        parms_id = context.first_parms_id
    cd = context.get_context_data(parms_id)
    limbs = cd.limb_constants
    tool = cd.galois_tool
    plan = KeySwitchPlan(context, parms_id)
    slots = cd.parms.poly_modulus_degree // 2

    # slot rotations are cyclic of order `slots`, so negative steps
    # normalize to slots + s (same group element, same key)
    norm = {}
    for s, v in diagonals.items():
        ns = int(s) % slots
        if ns in norm:
            raise ValueError("diagonal steps collide modulo the slot count")
        norm[ns] = v
    diagonals = norm
    steps = sorted(diagonals.keys())
    if baby is None:
        baby = max(1, int(np.ceil(np.sqrt(len(steps)))))
    B = int(baby)
    groups = {}                       # giant g -> {baby b: slot vector}
    for s in steps:
        g, b = divmod(s, B)
        groups.setdefault(g, {})[b] = np.asarray(
            list(diagonals[s]), dtype=np.complex128
        )
    giants = sorted(groups.keys())
    babies = sorted({b for gd in groups.values() for b in gd})
    baby_rot = [b for b in babies if b != 0]
    giant_rot = [g * B for g in giants if g != 0]
    rot_steps = baby_rot + giant_rot
    baby_elts = {b: tool.get_elt_from_step(b) for b in baby_rot}
    giant_elts = {g: tool.get_elt_from_step(g * B) for g in giants if g != 0}

    ext_mods = [Modulus(p) for p in plan.ext_moduli]
    ext_limbs = plan.ext_limbs

    def enc_pair(vec, pre_rot: int):
        """(ct-base, ext-base) NTT encodings of rot(vec, -pre_rot)."""
        v = np.roll(vec, pre_rot)[:slots].tolist()
        pt = np.asarray(encoder.encode(v, scale, parms_id).data)
        pt_ext = encoder.encode_at_base(v, scale, parms_id, ext_mods,
                                        plan.ext_tables)
        return pt, pt_ext

    plains = {
        (g, b): enc_pair(vec, g * B)
        for g, gd in groups.items() for b, vec in gd.items()
    }

    # ---- stacked constants: the whole BSGS grid as dense tensors --------
    # Absent (g, b) cells are zero plaintexts — they contribute exactly 0
    # through every modular contraction, so presence masks are free.
    babies_idx = {b: i for i, b in enumerate(babies)}
    Bf, Br, G = len(babies), len(baby_rot), len(giants)
    has_g0 = giants[0] == 0
    n_ext = plan.n_ext
    n_ct = plan.n_ct_rns
    N = cd.parms.poly_modulus_degree
    nb = plan.n_bundles
    pt_ct_stack = np.zeros((G, Bf, n_ct, N), dtype=np.uint64)
    pt_ext_stack = np.zeros((G, Bf, n_ext, N), dtype=np.uint64)
    for gi, g in enumerate(giants):
        for b in groups[g]:
            pt, pt_ext = plains[(g, b)]
            pt_ct_stack[gi, babies_idx[b]] = pt
            pt_ext_stack[gi, babies_idx[b]] = pt_ext
    baby_tabs = (np.stack([tool._ntt_table(baby_elts[b]) for b in baby_rot])
                 if Br else None)                      # [Br, N]
    rot_gi = [gi for gi, g in enumerate(giants) if g != 0]
    giant_tabs = (np.stack([tool._ntt_table(giant_elts[giants[gi]])
                            for gi in rot_gi])
                  if rot_gi else None)                 # [Gr, N]
    ext_idx = plan.ext_key_indices

    def step(ct, galois_keys_stack):
        """Batched BSGS schedule: ONE gather applies every baby rotation
        (stacked permutation tables), every inner product and diagonal
        contraction is a single 128-bit reduction over the baby/bundle
        axis, and the giant mod-downs + key switches run batched over the
        giant axis.  The traced graph is O(#bundles + #babies + #giants)
        ops instead of O(#babies * #giants) — the unbatched form XLA-
        compiles for tens of minutes at deep L (bootstrap C2S/S2C maps).
        Residues are bit-identical to the unbatched schedule: every
        contraction is exact mod p and zero cells add exact zeros."""
        c0 = ct[..., 0, :, :]
        c1 = ct[..., 1, :, :]
        q = limbs
        ext = ext_limbs
        ptc = jnp.asarray(pt_ct_stack)                 # [G, Bf, L, N]
        if Br:
            ct_k = compute_modup_digits(c1, plan, True)     # hoisted once
            a0, a1 = batched_rotated_inner_product(
                ct_k, baby_tabs, galois_keys_stack[:Br],
                plan)                                  # [..., Br, n_ext, N]
            rc = jnp.moveaxis(jnp.take(c0, jnp.asarray(baby_tabs), axis=-1),
                              -2, -3)

        def c0_row(bi):
            b = babies[bi]
            if b == 0:
                return c0[..., None, :, :]
            return rc[..., baby_rot.index(b), :, :][..., None, :, :]

        # S_g c0-plane for ALL giants: contract the baby axis once
        s0_ct = modops.accumulate_mulmod_128(
            ((c0_row(bi), ptc[:, bi]) for bi in range(Bf)),
            q.p, q.ratio0, q.ratio1)                   # [..., G, L, N]
        if 0 in babies_idx:
            s1_ct = dyadic_product(c1[..., None, :, :],
                                   ptc[:, babies_idx[0]], q)
        else:
            s1_ct = jnp.zeros_like(s0_ct)
        if Br:
            pte = jnp.asarray(pt_ext_stack)
            s0_raw = modops.accumulate_mulmod_128(
                ((a0[..., j, :, :][..., None, :, :],
                  pte[:, babies_idx[baby_rot[j]]]) for j in range(Br)),
                ext.p, ext.ratio0, ext.ratio1)         # [..., G, n_ext, N]
            s1_raw = modops.accumulate_mulmod_128(
                ((a1[..., j, :, :][..., None, :, :],
                  pte[:, babies_idx[baby_rot[j]]]) for j in range(Br)),
                ext.p, ext.ratio0, ext.ratio1)

        if has_g0:
            # S_0 folds straight into the final accumulators
            fin0_ct = s0_ct[..., 0, :, :]
            fin1_ct = s1_ct[..., 0, :, :]
            fin0_raw = s0_raw[..., 0, :, :] if Br else None
            fin1_raw = s1_raw[..., 0, :, :] if Br else None
        else:
            fin0_ct = fin1_ct = fin0_raw = fin1_raw = None

        if rot_gi:
            # materialize all rotated giants with ONE batched mod-down +
            # ONE batched key switch over the giant axis
            gs = slice(1, None) if has_g0 else slice(None)
            sg0 = s0_ct[..., gs, :, :]
            sg1 = s1_ct[..., gs, :, :]
            if Br:
                sg0 = add_poly(sg0, rescale_special(
                    s0_raw[..., gs, :, :], plan, is_ntt_output=True), q)
                sg1 = add_poly(sg1, rescale_special(
                    s1_raw[..., gs, :, :], plan, is_ntt_output=True), q)
            gt = jnp.asarray(giant_tabs)[:, None, :]   # [Gr, 1, N]
            gt = gt.reshape((1,) * (sg0.ndim - 3) + gt.shape)
            g0 = jnp.take_along_axis(sg0, jnp.broadcast_to(gt, sg0.shape),
                                     axis=-1)
            g1 = jnp.take_along_axis(sg1, jnp.broadcast_to(gt, sg1.shape),
                                     axis=-1)
            digits = compute_modup_digits(g1, plan, True)
            gkeys = galois_keys_stack[Br:][..., ext_idx, :]
            ga0 = modops.accumulate_mulmod_128(
                ((digits[..., b, :, :], gkeys[:, b, 0]) for b in range(nb)),
                ext.p, ext.ratio0, ext.ratio1)         # [..., Gr, n_ext, N]
            ga1 = modops.accumulate_mulmod_128(
                ((digits[..., b, :, :], gkeys[:, b, 1]) for b in range(nb)),
                ext.p, ext.ratio0, ext.ratio1)
            for i in range(len(rot_gi)):
                fin0_ct = (g0[..., i, :, :] if fin0_ct is None
                           else add_poly(fin0_ct, g0[..., i, :, :], q))
                fin0_raw = (ga0[..., i, :, :] if fin0_raw is None
                            else add_poly(fin0_raw, ga0[..., i, :, :], ext))
                fin1_raw = (ga1[..., i, :, :] if fin1_raw is None
                            else add_poly(fin1_raw, ga1[..., i, :, :], ext))

        out0 = fin0_ct
        out1 = fin1_ct
        if fin0_raw is not None:
            d0 = rescale_special(fin0_raw, plan, is_ntt_output=True)
            d1 = rescale_special(fin1_raw, plan, is_ntt_output=True)
            out0 = d0 if out0 is None else add_poly(out0, d0, limbs)
            out1 = d1 if out1 is None else add_poly(out1, d1, limbs)
        return jnp.stack([out0, out1], axis=-3)

    return step, rot_steps


def build_ckks_dense_layer(context: SealContext, diagonals, bias, scale: float,
                           encoder, parms_id=None, activation: str = "square",
                           bsgs: bool = False):
    """One ENTIRE encrypted dense layer y = act(M @ x + b) as a single
    jitted program (the ex9 flow fused end to end; no reference analogue —
    the reference composes per-op C++ calls):

    raw-accumulator hoisted matvec (ONE mod-up, ONE special-prime
    mod-down for all rotations) -> q_last rescale -> plaintext bias add
    -> square activation (3-product square + relin + rescale).

    diagonals: {step: slot values} of M (diagonal method); bias: slot
    values of b.  activation: "square" or None (linear layer).
    bsgs=True routes the matvec through build_ckks_matvec_bsgs
    (~2*sqrt(k) key switches; requires non-negative steps) — the
    rotation-key steps then differ from sorted(diagonals), so read them
    from the returned fn's `rot_steps` attribute (set for both paths).

    Returns (fn, out_parms_id, out_scale):
    fn(ct_data, galois_keys_stack, relin_key) -> u64[..., 2, L_out, N]
    NTT form at `out_scale`.
    """
    import numpy as np

    if parms_id is None:
        parms_id = context.first_parms_id
    cd0 = context.get_context_data(parms_id)
    cd1 = cd0.next_context_data
    if cd1 is None or (activation == "square" and cd1.next_context_data is None):
        raise ValueError("modulus chain too short for a dense layer")
    if bsgs:
        mv_step, rot_steps = build_ckks_matvec_bsgs(
            context, diagonals, scale, encoder, parms_id)
    else:
        mv_step = build_ckks_matvec(context, diagonals, scale, encoder,
                                    parms_id)
        rot_steps = [s for s in sorted(diagonals) if s != 0]
    q0 = cd0.parms.coeff_modulus[-1].value
    scale_r = scale * scale / q0
    limbs1 = cd1.limb_constants
    bias_pt = np.asarray(
        encoder.encode(list(bias), scale_r, cd1.parms_id).data
    )

    if activation == "square":
        plan1 = KeySwitchPlan(context, cd1.parms_id)
        tool1 = cd1.device_rns_tool
        tables1 = cd1.ntt_tables
        q1 = cd1.parms.coeff_modulus[-1].value
        out_parms_id = cd1.next_context_data.parms_id
        out_scale = scale_r * scale_r / q1
    elif activation is None:
        out_parms_id = cd1.parms_id
        out_scale = scale_r
    else:
        raise ValueError(f"unsupported activation {activation!r}")

    tool0 = cd0.device_rns_tool
    tables0 = cd0.ntt_tables

    def step(ct, galois_keys_stack, relin_key):
        y = mv_step(ct, galois_keys_stack)            # [.., 2, L0, N] scale^2
        y = divide_and_round_q_last_ntt(y, tool0, tables0)
        c0 = add_poly(y[..., 0, :, :], bias_pt, limbs1)
        y = jnp.concatenate([c0[..., None, :, :], y[..., 1:, :, :]], axis=-3)
        if activation == "square":
            d0, d1, d2 = _square3(y, limbs1)
            c0r, c1r = _relinearize_batched(d0, d1, d2, relin_key, plan1,
                                            limbs1, True)
            y = jnp.stack([c0r, c1r], axis=-3)
            y = divide_and_round_q_last_ntt(y, tool1, tables1)
        return y

    step.rot_steps = rot_steps
    return step, out_parms_id, out_scale


def build_ckks_conv2d(context: SealContext, kernel, height: int, width: int,
                      scale: float, encoder, bias=None, parms_id=None,
                      activation: str = None, periodic: bool = False):
    """Encrypted single-channel SAME-padding 2D convolution (+ bias +
    optional square activation) over a row-major image packed in the CKKS
    slots — the CNN building block of the encrypted-inference model zoo
    (no reference analogue; the reference stops at the op layer).

    A conv IS a matvec whose generalized diagonals are constant-per-tap:
    out[r,c] = sum_{dy,dx} K[dy,dx] * img[r+dy, c+dx], so tap (dy, dx)
    contributes diagonal step dy*width+dx holding K[dy,dx] MASKED to zero
    wherever the source pixel falls outside the image (this turns the
    slot-rotation's cyclic wrap into proper zero padding).  The whole
    layer therefore rides the fused hoisted-matvec machinery: ONE mod-up,
    ONE special-prime mod-down for all taps.

    kernel: [kh, kw] floats (odd dims); image: height*width slots,
    row-major, remaining slots zero.  periodic=True tiles the masked
    diagonals across the whole slot vector (requires slots % (h*w) == 0):
    with a block-periodic input the output is block-periodic too — the
    contract downstream dense layers need for their cyclic wraps (see
    build_ckks_cnn).  Returns
    (fn, out_parms_id, out_scale, rot_steps):
    fn(ct_data, galois_keys_stack, relin_key) -> u64[..., 2, L_out, N];
    make Galois keys for `rot_steps` (stack in that order).
    """
    import numpy as np

    k = np.asarray(kernel, dtype=np.float64)
    if k.ndim != 2 or k.shape[0] % 2 == 0 or k.shape[1] % 2 == 0:
        raise ValueError("kernel must be 2-D with odd dimensions")
    kh, kw = k.shape
    if parms_id is None:
        parms_id = context.first_parms_id
    cd = context.get_context_data(parms_id)
    slots = cd.parms.poly_modulus_degree // 2
    if height * width > slots:
        raise ValueError("image does not fit in the slot count")
    if abs(kw // 2) >= width or abs(kh // 2) >= height:
        raise ValueError("kernel larger than the image")
    if periodic and slots % (height * width) != 0:
        raise ValueError("periodic conv needs slot_count % (h*w) == 0")

    rr, cc = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    diagonals = {}
    for dy in range(-(kh // 2), kh // 2 + 1):
        for dx in range(-(kw // 2), kw // 2 + 1):
            wt = float(k[dy + kh // 2, dx + kw // 2])
            if wt == 0.0:
                continue
            valid = ((rr + dy >= 0) & (rr + dy < height)
                     & (cc + dx >= 0) & (cc + dx < width))
            mask = np.where(valid, wt, 0.0).reshape(-1)
            if periodic:
                mask = np.tile(mask, slots // (height * width))
            diagonals[dy * width + dx] = mask.tolist()

    if bias is None:
        bias = [0.0] * (height * width)
    fn, out_pid, out_scale = build_ckks_dense_layer(
        context, diagonals, bias, scale, encoder,
        parms_id=parms_id, activation=activation,
    )
    rot_steps = [s for s in sorted(diagonals.keys()) if s != 0]
    return fn, out_pid, out_scale, rot_steps


def strided_dense_diagonals(M, height: int, width: int, stride: int,
                            slots: int):
    """Fold average-pool-free striding into a dense layer: generalized
    diagonals of the slot-linear map that reads a stride-subsampled grid
    of an h*w image block and writes compact outputs at slots
    [0, ph*pw) (ph = ceil(h/stride), pw = ceil(w/stride)).

    Composing this after a conv layer gives stride-s CNN downsampling
    with NO extra ciphertext ops — the dense matvec's diagonals simply
    read the strided positions (the CryptoNets trick: absorb pooling
    into the next linear layer).  Scaled-mean pooling itself can be
    absorbed into M by the caller (each pooled pixel = mean of a window
    = rows of an enlarged M).

    M: [n_out, ph*pw] dense matrix over the POOLED pixels (n_out <=
    slots).  Returns {step: slot-values list} for build_ckks_matvec_bsgs
    / build_ckks_dense_layer(bsgs=True) — steps cluster near 0 and near
    `slots`, which the presence-based BSGS grouping keeps cheap.
    """
    import numpy as np

    M = np.asarray(M, dtype=np.float64)
    ph = (height + stride - 1) // stride
    pw = (width + stride - 1) // stride
    if M.shape[1] != ph * pw:
        raise ValueError("M columns must equal the pooled pixel count")
    n_out = M.shape[0]
    if n_out > slots or height * width > slots:
        raise ValueError("map does not fit in the slot count")
    src = np.array([
        (r * stride) * width + (c * stride)
        for r in range(ph) for c in range(pw)
    ])
    diagonals = {}
    for j in range(n_out):
        for jp in range(ph * pw):
            wt = float(M[j, jp])
            if wt == 0.0:
                continue
            step = (int(src[jp]) - j) % slots
            m = diagonals.setdefault(step, np.zeros(slots))
            m[j] += wt
    return {s: m.tolist() for s, m in diagonals.items()}


def build_ckks_conv2d_mc(context: SealContext, kernel, height: int,
                         width: int, scale: float, encoder, bias=None,
                         parms_id=None, activation: str = None,
                         periodic: bool = False):
    """Multi-channel encrypted 2D convolution: kernel [oc, ic, kh, kw]
    over a CHANNELS-BLOCKED slot packing (slot ch*h*w + r*w + c holds
    pixel (r, c) of channel ch).  Every (oc, ic, tap) contributes the
    generalized diagonal step (ic-oc)*h*w + dy*w + dx with the tap weight
    masked to valid (zero-padded) source pixels, so the whole multi-
    channel conv is ONE hoisted fused matvec — one mod-up, one mod-down,
    regardless of channel count (single-channel case:
    build_ckks_conv2d; no reference analogue).

    periodic=True tiles the masks with period oc*h*w for layer chaining
    (requires slots % (oc*h*w) == 0 and oc % ic == 0 so a block-periodic
    input stays block-periodic).  bias: oc*h*w slot values (or None).

    Returns (fn, out_parms_id, out_scale, rot_steps):
    fn(ct_data, galois_keys_stack, relin_key) -> u64[..., 2, L_out, N].
    """
    import numpy as np

    k = np.asarray(kernel, dtype=np.float64)
    if k.ndim != 4 or k.shape[2] % 2 == 0 or k.shape[3] % 2 == 0:
        raise ValueError("kernel must be [oc, ic, kh, kw] with odd kh/kw")
    OC, IC, kh, kw = k.shape
    if parms_id is None:
        parms_id = context.first_parms_id
    cd = context.get_context_data(parms_id)
    slots = cd.parms.poly_modulus_degree // 2
    hw = height * width
    if max(OC, IC) * hw > slots:
        raise ValueError("channel blocks do not fit in the slot count")
    if kh // 2 >= height or kw // 2 >= width:
        raise ValueError("kernel larger than the image")
    if periodic:
        if slots % (OC * hw) != 0:
            raise ValueError("periodic conv needs slots % (oc*h*w) == 0")
        if OC % IC != 0:
            raise ValueError("periodic chaining needs oc % ic == 0")

    rr, cc = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    out_len = OC * hw
    masks = {}
    for oc in range(OC):
        for ic in range(IC):
            for dy in range(-(kh // 2), kh // 2 + 1):
                for dx in range(-(kw // 2), kw // 2 + 1):
                    wt = float(k[oc, ic, dy + kh // 2, dx + kw // 2])
                    if wt == 0.0:
                        continue
                    step = (ic - oc) * hw + dy * width + dx
                    m = masks.setdefault(step, np.zeros(out_len))
                    valid = ((rr + dy >= 0) & (rr + dy < height)
                             & (cc + dx >= 0) & (cc + dx < width))
                    m[oc * hw:(oc + 1) * hw] += np.where(
                        valid, wt, 0.0).reshape(-1)

    diagonals = {}
    for step, m in masks.items():
        if periodic:
            m = np.tile(m, slots // out_len)
        diagonals[step] = m.tolist()

    if bias is None:
        bias = [0.0] * out_len
    fn, out_pid, out_scale = build_ckks_dense_layer(
        context, diagonals, list(bias), scale, encoder,
        parms_id=parms_id, activation=activation,
    )
    rot_steps = [s for s in sorted(diagonals.keys()) if s != 0]
    return fn, out_pid, out_scale, rot_steps


def build_ckks_logreg(context: SealContext, weights, intercept: float,
                      scale: float, encoder, parms_id=None):
    """Encrypted logistic-regression inference: p = sigmoid(w . x + b)
    with the degree-3 least-squares sigmoid approximation
    sigma(z) ~= 0.5 + 0.197 z - 0.004 z^3 (the standard HE logreg head).

    Dataflow (4 modulus levels): w (*) x plain product -> rescale ->
    log2 rotation doubling tree summing the feature slots (w . x lands in
    slot 0, replicated each 2^m block) -> + b -> z^2 (dedicated square +
    relin + rescale) -> u = a3 z^2 + a1 (plain) -> z * u (mul + relin +
    rescale) -> + 0.5.

    weights: F feature weights (F padded up to a power of two in-slot).
    Returns (fn, out_parms_id, out_scale, rot_steps):
    fn(x_data, galois_keys_stack, relin_key) -> u64[..., 2, L_out, N]
    whose slot 0 decrypts to sigma(w . x + b); x_data packs the features
    in slots [0, F) with the rest of each 2^m block zero.  Galois keys:
    power-of-two steps `rot_steps`, stacked in that order.
    """
    import numpy as np

    if parms_id is None:
        parms_id = context.first_parms_id
    cd0 = context.get_context_data(parms_id)
    F = len(list(weights))
    m = max(1, int(np.ceil(np.log2(max(F, 2)))))
    slots = cd0.parms.poly_modulus_degree // 2
    if (1 << m) > slots:
        raise ValueError("feature count does not fit in the slot count")

    # level chain: z at cd1, z^2 at cd2, u at cd3, output at cd4
    cds = [cd0]
    for _ in range(4):
        nxt = cds[-1].next_context_data
        if nxt is None:
            raise ValueError("modulus chain too short for logreg (needs 5)")
        cds.append(nxt)
    cd1, cd2, cd3, cd4 = cds[1:]
    q = [c.parms.coeff_modulus[-1].value for c in cds[:4]]

    w_full = np.zeros(slots, dtype=np.float64)
    w_full[:F] = np.asarray(list(weights), dtype=np.float64)
    w_pt = np.asarray(encoder.encode(w_full.tolist(), scale, parms_id).data)

    s1 = float(scale) * float(scale) / q[0]          # z scale at cd1
    b_pt = np.asarray(encoder.encode(float(intercept), s1, cd1.parms_id).data)
    s2 = s1 * s1 / q[1]                              # z^2 scale at cd2
    A1, A3 = 0.197, -0.004
    a3_pt = np.asarray(encoder.encode(A3, float(q[2]), cd2.parms_id).data)
    su = s2 * float(q[2]) / q[2]                     # = s2, u scale at cd3
    a1_pt = np.asarray(encoder.encode(A1, su, cd3.parms_id).data)
    out_scale = s1 * su / q[3]
    half_pt = np.asarray(encoder.encode(0.5, out_scale, cd4.parms_id).data)

    limbs1 = cd1.limb_constants
    limbs2 = cd2.limb_constants
    limbs3 = cd3.limb_constants
    limbs4 = cd4.limb_constants
    L1 = len(cd1.parms.coeff_modulus)
    L3 = len(cd3.parms.coeff_modulus)
    plan1 = KeySwitchPlan(context, cd1.parms_id)
    tool1 = cd1.galois_tool
    rot_steps = [1 << i for i in range(m)]

    sq = build_ckks_mul_relin_rescale(context, cd1.parms_id, square=True)
    mul3 = build_ckks_mul_relin_rescale(context, cd3.parms_id)

    def step(x, galois_keys_stack, relin_key):
        # w (*) x, rescale -> z0 at cd1
        t = jnp.stack([
            dyadic_product(x[..., 0, :, :], w_pt, cds[0].limb_constants),
            dyadic_product(x[..., 1, :, :], w_pt, cds[0].limb_constants),
        ], axis=-3)
        t = divide_and_round_q_last_ntt(
            t, cds[0].device_rns_tool, cds[0].ntt_tables
        )
        # rotation doubling tree: z[i] = sum_j t[i+j] over each 2^m block
        for i in range(m):
            elt = tool1.get_elt_from_step(1 << i)
            rc0 = tool1.apply_galois_ntt(t[..., 0, :, :], elt)
            rc1 = tool1.apply_galois_ntt(t[..., 1, :, :], elt)
            d0, d1 = switch_key(rc1, galois_keys_stack[i], plan1, True)
            rot = jnp.stack([add_poly(rc0, d0, limbs1), d1], axis=-3)
            t = add_poly(t, rot, limbs1)
        # + b
        zc0 = add_poly(t[..., 0, :, :], b_pt, limbs1)
        z = jnp.concatenate([zc0[..., None, :, :], t[..., 1:, :, :]], axis=-3)
        # z^2 at cd2
        z2 = sq(z, relin_key)
        # u = a3 * z^2 (+ a1), rescale -> cd3
        u = jnp.stack([
            dyadic_product(z2[..., 0, :, :], a3_pt, limbs2),
            dyadic_product(z2[..., 1, :, :], a3_pt, limbs2),
        ], axis=-3)
        u = divide_and_round_q_last_ntt(
            u, cd2.device_rns_tool, cd2.ntt_tables
        )
        uc0 = add_poly(u[..., 0, :, :], a1_pt, limbs3)
        u = jnp.concatenate([uc0[..., None, :, :], u[..., 1:, :, :]], axis=-3)
        # y = z * u (z mod-switch-dropped to cd3) -> cd4
        y = mul3(z[..., :L3, :], u, relin_key)
        # + 0.5
        yc0 = add_poly(y[..., 0, :, :], half_pt, limbs4)
        return jnp.concatenate([yc0[..., None, :, :], y[..., 1:, :, :]],
                               axis=-3)

    return step, cd4.parms_id, out_scale, rot_steps


def build_ckks_logreg_train_step(context: SealContext, m: int, F: int,
                                 labels, alpha: float, scale: float,
                                 encoder, parms_id=None):
    """ONE encrypted gradient-descent iteration of logistic regression —
    both the data X and the model w stay encrypted end to end (the
    iDASH-style HE training workload; no reference analogue).

        w' = w - alpha * X^T (sigma3(X w) - y),
        sigma3(z) = 0.5 + 0.197 z - 0.004 z^3.

    Packing: sample i occupies slot block [i*Bf, (i+1)*Bf) with its F
    features first (Bf = next power of two >= F); w is replicated in
    every block.  The iteration is 4 ciphertext x ciphertext products +
    2 masked rotation trees (in-block sum for z = x_i . w, cross-block
    sum for the gradient), consuming 7 modulus levels; the output w' is
    replicated per block at the INPUT scale (self-similar: feed it and a
    7-level-dropped X straight into the next iteration's program).

    labels: m values in [0, 1] (baked in as the plaintext 0.5 - y term;
    pass an encrypted-label variant through sub() externally if labels
    are private too).  alpha is absorbed into the gradient mask — no
    extra level.

    Returns (fn, out_parms_id, out_scale, rot_steps):
    fn(X_data, w_data, galois_keys_stack, relin_key) -> u64[..., 2, L-7, N]
    with galois keys for the signed `rot_steps`, stacked in that order.
    """
    import numpy as np

    if parms_id is None:
        parms_id = context.first_parms_id
    cd0 = context.get_context_data(parms_id)
    slots = cd0.parms.poly_modulus_degree // 2
    b = max(1, int(np.ceil(np.log2(max(F, 2)))))
    Bf = 1 << b
    lm = max(1, int(np.ceil(np.log2(max(m, 2)))))
    mp = 1 << lm
    if mp * Bf > slots:
        raise ValueError("m x F packing does not fit in the slot count")
    labels = list(labels)
    if len(labels) != m:
        raise ValueError("labels must have m entries")

    cds = [cd0]
    for _ in range(7):
        nxt = cds[-1].next_context_data
        if nxt is None:
            raise ValueError("modulus chain too short (needs 8 levels)")
        cds.append(nxt)
    q = [c.parms.coeff_modulus[-1].value for c in cds[:7]]
    L = [len(c.parms.coeff_modulus) for c in cds]
    limbs = [c.limb_constants for c in cds]
    tools = {i: cds[i].galois_tool for i in (1, 2, 6, 7)}
    plans = {i: KeySwitchPlan(context, cds[i].parms_id) for i in (1, 2, 6, 7)}

    # scale ladder (see docstring derivation): self-similar output scale
    sc = float(scale)
    s1 = sc * sc / q[0]                      # u = X (*) w at L1
    sz2 = s1 * s1 / q[2]                     # z^2 at L3 (mask keeps s1)
    sv = s1 * sz2 / q[4]                     # v = z*(c3 z^2 + c1) at L5
    sp = sv * sc / q[5]                      # p = d (*) X at L6
    alpha_scale = q[6] * sc / sp             # makes alpha*g land at sc

    A1, A3 = 0.197, -0.004
    mask1 = np.zeros(slots)
    mask1[::Bf] = 1.0
    mask1_pt = np.asarray(
        encoder.encode(mask1.tolist(), float(q[1]), cds[1].parms_id).data)
    c3_pt = np.asarray(
        encoder.encode(A3, float(q[3]), cds[3].parms_id).data)
    c1_pt = np.asarray(encoder.encode(A1, sz2, cds[4].parms_id).data)
    # 0.5 - y replicated per block; unused blocks get 0 (their v is 0 too)
    c0y = np.zeros(slots)
    for i in range(slots // Bf):
        c0y[i * Bf:(i + 1) * Bf] = (0.5 - labels[i]) if i < m else 0.0
    c0y_pt = np.asarray(encoder.encode(c0y.tolist(), sv, cds[5].parms_id).data)
    mask2 = np.zeros(slots)
    mask2[:Bf] = float(alpha)
    mask2_pt = np.asarray(
        encoder.encode(mask2.tolist(), alpha_scale, cds[6].parms_id).data)

    mul0 = build_ckks_mul_relin_rescale(context, cds[0].parms_id)
    sq2 = build_ckks_mul_relin_rescale(context, cds[2].parms_id, square=True)
    mul4 = build_ckks_mul_relin_rescale(context, cds[4].parms_id)
    mul5 = build_ckks_mul_relin_rescale(context, cds[5].parms_id)

    tree_steps = [1 << j for j in range(b)]
    spread_steps = [-(1 << j) for j in range(b)]
    xtree_steps = [Bf << j for j in range(lm)]
    xspread_steps = [-(Bf << j) for j in range(lm)]
    rot_steps = tree_steps + spread_steps + xtree_steps + xspread_steps
    key_idx = {s: i for i, s in enumerate(rot_steps)}

    def rotate(x, step, lvl, keys):
        tool, plan, lb = tools[lvl], plans[lvl], limbs[lvl]
        elt = tool.get_elt_from_step(step)
        rc0 = tool.apply_galois_ntt(x[..., 0, :, :], elt)
        rc1 = tool.apply_galois_ntt(x[..., 1, :, :], elt)
        d0, d1 = switch_key(rc1, keys[key_idx[step]], plan, True)
        return jnp.stack([add_poly(rc0, d0, lb), d1], axis=-3)

    def plain_mul_rescale(x, pt, lvl):
        t = jnp.stack([
            dyadic_product(x[..., 0, :, :], pt, limbs[lvl]),
            dyadic_product(x[..., 1, :, :], pt, limbs[lvl]),
        ], axis=-3)
        return divide_and_round_q_last_ntt(
            t, cds[lvl].device_rns_tool, cds[lvl].ntt_tables)

    def plain_add(x, pt, lvl):
        c0 = add_poly(x[..., 0, :, :], pt, limbs[lvl])
        return jnp.concatenate([c0[..., None, :, :], x[..., 1:, :, :]],
                               axis=-3)

    def step(X, w, galois_keys_stack, relin_key):
        gk = galois_keys_stack
        u = mul0(X, w, relin_key)                          # L1, s1
        for s in tree_steps:                               # in-block sum
            u = add_poly(u, rotate(u, s, 1, gk), limbs[1])
        z = plain_mul_rescale(u, mask1_pt, 1)              # L2, s1
        for s in spread_steps:                             # replicate z_i
            z = add_poly(z, rotate(z, s, 2, gk), limbs[2])
        z2 = sq2(z, relin_key)                             # L3, sz2
        up = plain_mul_rescale(z2, c3_pt, 3)               # L4, sz2
        up = plain_add(up, c1_pt, 4)
        v = mul4(z[..., :L[4], :], up, relin_key)          # L5, sv
        d = plain_add(v, c0y_pt, 5)                        # sigma(z) - y
        p = mul5(d, X[..., :L[5], :], relin_key)           # L6, sp
        for s in xtree_steps:                              # cross-block sum
            p = add_poly(p, rotate(p, s, 6, gk), limbs[6])
        ga = plain_mul_rescale(p, mask2_pt, 6)             # L7, alpha*g @ sc
        for s in xspread_steps:                            # replicate grad
            ga = add_poly(ga, rotate(ga, s, 7, gk), limbs[7])
        wd = w[..., :L[7], :]                              # mod-drop w
        return jnp.stack([
            sub_poly(wd[..., 0, :, :], ga[..., 0, :, :], limbs[7]),
            sub_poly(wd[..., 1, :, :], ga[..., 1, :, :], limbs[7]),
        ], axis=-3)

    return step, cds[7].parms_id, sc, rot_steps


def build_ckks_cnn(context: SealContext, convs, dense, height: int,
                   width: int, scale: float, encoder, bsgs: bool = True):
    """Encrypted CNN inference: convolution layers over a slot-packed
    row-major image followed by dense layers, chained down the modulus
    chain as ONE jittable program (the CryptoNets-style flagship of the
    model zoo; no reference analogue — the reference stops at the op
    layer).

    The input image must be packed BLOCK-PERIODICALLY: slot i holds pixel
    (i mod h*w) of the row-major image, repeated across the whole slot
    vector (slots % (h*w) == 0) — conv layers run in periodic mode so
    every layer's output keeps the periodic contract the dense layers'
    cyclic rotations rely on.

    convs: [(kernel, bias_slot_values_or_None, activation), ...] where
    kernel is [kh, kw] (single-channel, build_ckks_conv2d) or
    [oc, ic, kh, kw] (channels-blocked multi-channel,
    build_ckks_conv2d_mc) — stride-1 SAME convs via masked diagonals;
    dense: [(diagonals, bias, activation), ...] (diagonal method;
    bsgs=True routes them through the baby-step/giant-step schedule).
    Each linear layer consumes one modulus level, each squared layer two.

    Returns (fn, out_parms_id, out_scale):
    fn(ct_data, [gk_stack_per_layer], relin_key) -> u64[..., 2, L_out, N];
    per-layer rotation-key steps on fn.rot_steps (list of lists, conv
    layers first).
    """
    fns = []
    steps_all = []
    pid = context.first_parms_id
    cur = float(scale)
    import numpy as np

    for kernel, bias, act in convs:
        builder = (build_ckks_conv2d_mc
                   if np.asarray(kernel).ndim == 4 else build_ckks_conv2d)
        fn, pid, cur, rsteps = builder(
            context, kernel, height, width, cur, encoder,
            bias=bias, parms_id=pid, activation=act, periodic=True,
        )
        fns.append(fn)
        steps_all.append(rsteps)
    for diagonals, bias, act in dense:
        fn, pid, cur = build_ckks_dense_layer(
            context, diagonals, bias, cur, encoder,
            parms_id=pid, activation=act, bsgs=bsgs,
        )
        fns.append(fn)
        steps_all.append(fn.rot_steps)

    def step(ct, gk_stacks, relin_key):
        y = ct
        for fn, g in zip(fns, gk_stacks):
            y = fn(y, g, relin_key)
        return y

    step.rot_steps = steps_all
    return step, pid, cur


def build_bfv_matvec(context: SealContext, diagonals, batch_encoder,
                     parms_id=None) -> Callable:
    """Encrypted BFV matrix-vector product by the diagonal method with
    HOISTED rotations and a SINGLE fused mod-down (the BFV twin of
    build_ckks_matvec; integer/slot-exact inference over batched rows).

    y = sum_d diag_d (*) rot_rows(x, d): one mod-up digit decomposition
    feeds every rotation's raw key-switch inner product; the raws are
    multiplied by extended-base NTT encodings of the (centered) diagonal
    plaintexts, summed, and special-prime rescaled ONCE; the rot(c0)
    plaintext products ride one shared forward NTT of c0.  Per matvec:
    1 mod-up + k inner products + 1 mod-down + 3 full-poly NTT passes —
    vs k of everything in the eager composition.

    diagonals: {step d: list of slot values in [0, t)} for the nonzero
    generalized diagonals.  Returns fn(ct, galois_keys_stack) ->
    u64[..., 2, L, N] power basis at the same level (decrypt-equal to the
    eager rotate/multiply_plain/add composition within sub-noise
    rounding).
    """
    import numpy as np

    if parms_id is None:
        parms_id = context.first_parms_id
    cd = context.get_context_data(parms_id)
    limbs = cd.limb_constants
    tool = cd.galois_tool
    tables = cd.ntt_tables
    plan = KeySwitchPlan(context, parms_id)
    thresh = cd.plain_upper_half_threshold
    t = cd.parms.plain_modulus.value
    n = cd.parms.poly_modulus_degree

    steps = sorted(diagonals.keys())
    rot_steps = [s for s in steps if s != 0]
    elts = [tool.get_elt_from_step(s) for s in rot_steps]

    def lift(plain_data, moduli):
        """Centered plain lift: residues of (v - t if v >= thresh else v)
        over an arbitrary modulus set (evaluator.cpp:1560-1580 semantics,
        valid beyond the ct base because it works on the signed value)."""
        pdata = np.zeros(n, dtype=np.int64)
        arr = np.asarray(plain_data, dtype=np.int64)
        pdata[: arr.shape[0]] = arr
        w = np.where(pdata >= np.int64(thresh), pdata - np.int64(t), pdata)
        out = np.zeros((len(moduli), n), dtype=np.uint64)
        for j, m in enumerate(moduli):
            out[j] = np.mod(w, np.int64(m.value)).astype(np.uint64)
        return out

    from ..modulus import Modulus

    ct_mods = cd.parms.coeff_modulus
    ext_mods = [Modulus(p) for p in plan.ext_moduli]
    plains = {}
    plains_ext = {}
    for s in steps:
        pt = batch_encoder.encode(list(diagonals[s]))
        plains[s] = np.asarray(
            ntt_forward(lift(pt.data, ct_mods), tables), dtype=np.uint64
        )
        if s != 0:
            plains_ext[s] = np.asarray(
                ntt_forward(lift(pt.data, ext_mods), plan.ext_tables),
                dtype=np.uint64,
            )
    ext_limbs = plan.ext_limbs

    from ..ops.keyswitch import rescale_special
    from ..ops.ntt import ntt_inverse as _ntt_inverse

    # stacked rotation tables + plaintext grids (one gather / one batched
    # contraction per plane — see build_ckks_matvec_bsgs.step)
    R = len(rot_steps)
    rot_tabs = (np.stack([tool._ntt_table(e) for e in elts]) if R else None)
    ptc_rot = (np.stack([plains[s] for s in rot_steps]) if R else None)
    pte_rot = (np.stack([plains_ext[s] for s in rot_steps]) if R else None)

    def step(ct, galois_keys_stack):
        c0 = ct[..., 0, :, :]
        c1 = ct[..., 1, :, :]
        c0_ntt = ntt_forward(c0, tables)
        acc0 = acc1 = None
        if 0 in plains:
            c1_ntt = ntt_forward(c1, tables)
            acc0 = dyadic_product(c0_ntt, plains[0], limbs)
            acc1 = dyadic_product(c1_ntt, plains[0], limbs)
        if rot_steps:
            tabs = jnp.asarray(rot_tabs)
            ct_k = compute_modup_digits(c1, plan, False)   # hoisted once
            a0, a1 = batched_rotated_inner_product(
                ct_k, rot_tabs, galois_keys_stack, plan)
            pte = jnp.asarray(pte_rot)
            raw0 = modops.accumulate_mulmod_128(
                ((a0[..., r, :, :], pte[r]) for r in range(R)),
                ext_limbs.p, ext_limbs.ratio0, ext_limbs.ratio1)
            raw1 = modops.accumulate_mulmod_128(
                ((a1[..., r, :, :], pte[r]) for r in range(R)),
                ext_limbs.p, ext_limbs.ratio0, ext_limbs.ratio1)
            rc = jnp.moveaxis(jnp.take(c0_ntt, tabs, axis=-1), -2, -3)
            ptcj = jnp.asarray(ptc_rot)
            p0 = modops.accumulate_mulmod_128(
                ((rc[..., r, :, :], ptcj[r]) for r in range(R)),
                limbs.p, limbs.ratio0, limbs.ratio1)
            acc0 = p0 if acc0 is None else add_poly(acc0, p0, limbs)
            d0 = rescale_special(raw0, plan, is_ntt_output=True)
            d1 = rescale_special(raw1, plan, is_ntt_output=True)
            acc0 = add_poly(acc0, d0, limbs)
            acc1 = d1 if acc1 is None else add_poly(acc1, d1, limbs)
        out0 = _ntt_inverse(acc0, tables)
        out1 = _ntt_inverse(acc1, tables)
        return jnp.stack([out0, out1], axis=-3)

    return step


def build_ckks_mlp(context: SealContext, layers, scale: float, encoder,
                   bsgs: bool = False):
    """Multi-layer encrypted MLP: chain of build_ckks_dense_layer programs
    walking down the modulus chain (each linear layer consumes one level,
    each square-activated layer two).

    layers: [(diagonals, bias, activation), ...] with activation "square"
    or None.  bsgs routes every matvec through the baby-step/giant-step
    schedule; per-layer rotation-key steps are on the returned fn's
    `rot_steps` attribute (a list of lists, one per layer).

    Returns (fn, out_parms_id, out_scale):
    fn(ct_data, [gk_stack_per_layer], relin_key) -> u64[..., 2, L_out, N].
    """
    fns = []
    pid = context.first_parms_id
    cur_scale = float(scale)
    for diagonals, bias, act in layers:
        fn, pid, cur_scale = build_ckks_dense_layer(
            context, diagonals, bias, cur_scale, encoder,
            parms_id=pid, activation=act, bsgs=bsgs,
        )
        fns.append(fn)

    def step(ct, gk_stacks, relin_key):
        y = ct
        for fn, g in zip(fns, gk_stacks):
            y = fn(y, g, relin_key)
        return y

    step.rot_steps = [fn.rot_steps for fn in fns]
    return step, pid, cur_scale


def build_ckks_inverse(context: SealContext, scale: float, encoder,
                       iters: int = 4, parms_id=None):
    """Encrypted reciprocal 1/a by Goldschmidt iteration — the division
    primitive CKKS lacks natively (and the reference cannot express at
    all: its Evaluator has no ciphertext division, evaluator.h):

        x_0 = 2 - a = 1 + e_0,  e_0 = 1 - a
        e_{k+1} = e_k^2,  x_{k+1} = x_k (1 + e_{k+1})

    (1-e) * prod_j (1 + e^(2^j)) telescopes to 1 - e^(2^(m+1)), so
    a * x_m = 1 - e_0^(2^(iters+1)): quadratic convergence for slot
    values a in (0, 2) (rescale inputs into that window first).  The
    e-square chain runs ONE level ahead of the x-multiply chain (the
    factor for x_{k+1} is the FRESH e_{k+1}, not the e_k already folded
    into x_k); each iteration consumes one level on each chain, staggered,
    for iters + 1 levels total.

    Returns (fn, out_parms_id, out_scale); fn(ct_a, relin_key) with ct_a
    at `scale`.
    """
    import numpy as np

    if parms_id is None:
        parms_id = context.first_parms_id
    if iters < 1:
        raise ValueError("need at least one iteration")
    ids = [parms_id]
    for _ in range(iters + 1):
        nxt = context.get_context_data(ids[-1]).next_context_data
        if nxt is None:
            raise ValueError(f"modulus chain too short: inverse needs "
                             f"{iters + 1} levels")
        ids.append(nxt.parms_id)
    cds = [context.get_context_data(i) for i in ids]
    limbs = [c.limb_constants for c in cds]
    q = [float(c.parms.coeff_modulus[-1].value) for c in cds]
    Ls = [len(c.parms.coeff_modulus) for c in cds]

    sqs = [build_ckks_mul_relin_rescale(context, ids[k], square=True)
           for k in range(iters)]           # e_k -> e_{k+1} at level k
    muls = [build_ckks_mul_relin_rescale(context, ids[k + 1])
            for k in range(iters)]          # x_k -> x_{k+1} at level k+1

    # separate scale tracks (the chains are staggered)
    sig_e = [float(scale)]
    for k in range(iters):
        sig_e.append(sig_e[k] * sig_e[k] / q[k])
    sig_x = [float(scale)]
    for k in range(iters):
        sig_x.append(sig_x[k] * sig_e[k + 1] / q[k + 1])
    two0 = np.asarray(encoder.encode(2.0, sig_x[0], ids[0]).data)
    one0 = np.asarray(encoder.encode(1.0, sig_e[0], ids[0]).data)
    # 1 aligned to e_{k+1}'s scale at level k+1 (the x-factor constants)
    ones = [np.asarray(encoder.encode(1.0, sig_e[k + 1], ids[k + 1]).data)
            for k in range(iters)]

    def _neg_plus(ct, pt, lim):
        """pt - ct for a 2-component ciphertext (plain minus cipher)."""
        n0 = modops.neg_mod(ct[..., 0, :, :], lim.p)
        n1 = modops.neg_mod(ct[..., 1, :, :], lim.p)
        return jnp.stack([add_poly(n0, pt, lim), n1], axis=-3)

    def step(ct_a, relin_key):
        x = _neg_plus(ct_a, two0, limbs[0])            # 1 + e_0, level 0
        e = _neg_plus(ct_a, one0, limbs[0])            # e_0, level 0
        for k in range(iters):
            e = sqs[k](e, relin_key)                   # e_{k+1}, level k+1
            lim = limbs[k + 1]
            factor = jnp.concatenate([
                add_poly(e[..., 0:1, :, :], ones[k], lim),
                e[..., 1:, :, :]], axis=-3)            # 1 + e_{k+1}
            x = muls[k](x[..., :Ls[k + 1], :], factor, relin_key)
        return x                                       # level iters + 1

    return step, ids[iters + 1], sig_x[iters]


def build_ckks_rsqrt(context: SealContext, scale: float, encoder,
                     iters: int = 3, parms_id=None):
    """Encrypted inverse square root 1/sqrt(a) by Newton iteration

        y_0 = 1,   y_{k+1} = y_k (3 - a y_k^2) / 2

    for slot values a in (0, 2): with e_k = 1 - a y_k^2 the error map is
    e_{k+1} = (3 e_k^2 + e_k^3) / 4 — quadratic once |e| < 1.  Each
    iteration consumes 4 levels (y^2, a*y^2, y*(3 - a y^2)/2, closing
    rescale); the 3/2 and 1/2 constants encode at the EvalMod alignment
    scale Dl^2 so the working scale stays stationary across iterations.
    Combine with build_ckks_sqrt for sqrt(a) = a * rsqrt(a).

    Returns (fn, out_parms_id, out_scale); fn(ct_a, relin_key) with ct_a
    at `scale`.
    """
    import numpy as np

    if parms_id is None:
        parms_id = context.first_parms_id
    if iters < 1:
        raise ValueError("need at least one iteration")
    n_levels = 4 * iters
    ids = [parms_id]
    for _ in range(n_levels):
        nxt = context.get_context_data(ids[-1]).next_context_data
        if nxt is None:
            raise ValueError(f"modulus chain too short: rsqrt needs "
                             f"{n_levels} levels")
        ids.append(nxt.parms_id)
    cds = [context.get_context_data(i) for i in ids]
    limbs = [c.limb_constants for c in cds]
    q = [float(c.parms.coeff_modulus[-1].value) for c in cds]
    Ls = [len(c.parms.coeff_modulus) for c in cds]
    Dl = float(scale)

    def _enc(val, sc, lvl):
        return np.asarray(encoder.encode(float(val), sc, ids[lvl]).data)

    stages = []
    sigma_y = Dl          # y_0 = 1 is re-encoded per build at input scale
    sigma_a = Dl
    for k in range(iters):
        b = 4 * k
        sq_y = build_ckks_mul_relin_rescale(context, ids[b], square=True)
        mul_u = build_ckks_mul_relin_rescale(context, ids[b + 1])
        mul_w = build_ckks_mul_relin_rescale(context, ids[b + 2])
        sigma_t = sigma_y * sigma_y / q[b]              # level b+1
        sigma_u = sigma_a * sigma_t / q[b + 1]          # level b+2
        sigma_v = Dl * Dl
        pt_half = _enc(0.5, sigma_v / sigma_u, b + 2)
        pt_3half = _enc(1.5, sigma_v, b + 2)
        sigma_w = sigma_y * sigma_v / q[b + 2]          # level b+3
        cd3 = cds[b + 3]
        sigma_y = sigma_w / q[b + 3]                    # level b+4

        def stage(y, ct_a, relin_key, b=b, sq_y=sq_y, mul_u=mul_u,
                  mul_w=mul_w, pt_half=pt_half, pt_3half=pt_3half, cd3=cd3):
            t = sq_y(y, relin_key)                      # y^2, level b+1
            u = mul_u(ct_a[..., : Ls[b + 1], :], t, relin_key)  # a y^2
            lim2 = limbs[b + 2]
            v0 = sub_poly(pt_3half,
                          dyadic_product(u[..., 0, :, :], pt_half, lim2),
                          lim2)                         # 1.5 - u0/2
            v1 = modops.neg_mod(
                dyadic_product(u[..., 1, :, :], pt_half, lim2), lim2.p)
            v = jnp.stack([v0, v1], axis=-3)
            w = mul_w(y[..., : Ls[b + 2], :], v, relin_key)
            return divide_and_round_q_last_ntt(
                w, cd3.device_rns_tool, cd3.ntt_tables)

        stages.append(stage)

    one0 = _enc(1.0, Dl, 0)

    def step(ct_a, relin_key):
        # y_0 = 1 as a transparent-free plaintext start: (one0, 0)
        y = jnp.stack([
            jnp.broadcast_to(one0, ct_a[..., 0, :, :].shape),
            jnp.zeros_like(ct_a[..., 1, :, :])], axis=-3)
        for stage in stages:
            y = stage(y, ct_a, relin_key)
        return y

    return step, ids[n_levels], sigma_y


def build_ckks_sqrt(context: SealContext, scale: float, encoder,
                    iters: int = 3, parms_id=None):
    """Encrypted sqrt(a) = a * rsqrt(a) for slot values in (0, 2):
    build_ckks_rsqrt plus one closing multiply with the mod-switched
    input.  4 * iters + 1 levels.

    Returns (fn, out_parms_id, out_scale); fn(ct_a, relin_key).
    """
    if parms_id is None:
        parms_id = context.first_parms_id
    rs_fn, rs_pid, rs_scale = build_ckks_rsqrt(
        context, scale, encoder, iters=iters, parms_id=parms_id)
    rs_cd = context.get_context_data(rs_pid)
    out_cd = rs_cd.next_context_data
    if out_cd is None:
        raise ValueError("modulus chain too short: sqrt needs one more "
                         "level after rsqrt")
    L_s = len(rs_cd.parms.coeff_modulus)
    mul_out = build_ckks_mul_relin_rescale(context, rs_pid)
    q_last = float(rs_cd.parms.coeff_modulus[-1].value)
    out_scale = rs_scale * float(scale) / q_last

    def step(ct_a, relin_key):
        y = rs_fn(ct_a, relin_key)
        return mul_out(ct_a[..., : L_s, :], y, relin_key)

    return step, out_cd.parms_id, out_scale


#: Odd degree-7 minimax component polynomials for composite sign
#: evaluation (Cheon-Kim-Kim, Asiacrypt'20): p(x) = x * q(x^2) with
#: q(y) = c0 + c1 y + c2 y^2 + c3 y^3.  f3 contracts toward +-1 on
#: [-1, 1] (f3(1) = 1); g3 widens the step first so fewer total
#: compositions reach a target resolution.
SIGN_F3 = (35 / 16, -35 / 16, 21 / 16, -5 / 16)
SIGN_G3 = (4589 / 1024, -16577 / 1024, 25614 / 1024, -12860 / 1024)


def sign_composite_reference(x, n_g: int = 1, n_f: int = 2):
    """Plain evaluation of the g3^(n_g) then f3^(n_f) composition — the
    exact curve the encrypted pipeline approximates (for tests/tuning)."""
    import numpy as np

    def _p(c, v):
        y = v * v
        return v * (c[0] + c[1] * y + c[2] * y * y + c[3] * y * y * y)

    v = np.asarray(x, dtype=np.float64)
    for _ in range(n_g):
        v = _p(SIGN_G3, v)
    for _ in range(n_f):
        v = _p(SIGN_F3, v)
    return v


def build_ckks_sign(context: SealContext, scale: float, encoder,
                    n_g: int = 1, n_f: int = 2, parms_id=None):
    """Encrypted sign(a) for slot values in [-1, 1] by the composite
    minimax schedule sign = f3^(n_f) o g3^(n_g) — the comparison
    primitive (max, ReLU, argmin, thresholding) that neither CKKS
    natively nor the reference's op set provides.

    Each odd degree-7 stage consumes 4 levels (y = x^2, y^2,
    (c2 + c3 y) * y^2, x * q(y)) with plaintext coefficients scale-
    aligned per level exactly like the bootstrap's EvalMod; total
    4 * (n_g + n_f) levels.  Resolution (measured on a plain grid): the
    default (1, 2) is within 7e-3 of +-1 for |a| >= 0.1; (2, 2) reaches
    2e-2 at |a| >= 0.02, (2, 3) 9e-3 at |a| >= 0.01 — use
    sign_composite_reference to tune stage counts to a target gap.

    Returns (fn, out_parms_id, out_scale); fn(ct_a, relin_key).
    """
    import numpy as np

    if parms_id is None:
        parms_id = context.first_parms_id
    stages = [SIGN_G3] * n_g + [SIGN_F3] * n_f
    n_levels = 4 * len(stages)
    ids = [parms_id]
    for _ in range(n_levels):
        nxt = context.get_context_data(ids[-1]).next_context_data
        if nxt is None:
            raise ValueError(f"modulus chain too short: sign needs "
                             f"{n_levels} levels")
        ids.append(nxt.parms_id)
    cds = [context.get_context_data(i) for i in ids]
    limbs = [c.limb_constants for c in cds]
    q = [float(c.parms.coeff_modulus[-1].value) for c in cds]
    Ls = [len(c.parms.coeff_modulus) for c in cds]
    Dl = float(scale)

    def _enc(val, sc, lvl):
        return np.asarray(encoder.encode(float(val), sc, ids[lvl]).data)

    def make_stage(b, coeffs, sigma_x):
        """One odd degree-7 application p(x) = hi(x) * x^4 + lo(x) with
        hi = c2 x + c3 x^3, lo = c0 x + c1 x^3, starting at level b with
        input scale sigma_x, ending at b + 4 with output scale ~ Dl
        (the EvalMod alignment pattern: coefficients encode at
        sigma_hi = Dl^2 so their encode scales stay ~ Dl, and the
        resulting Dl^2-scaled sum gets one closing rescale —
        models/bootstrap.py make_evalmod)."""
        sq_x2 = build_ckks_mul_relin_rescale(context, ids[b], square=True)
        mul_x3 = build_ckks_mul_relin_rescale(context, ids[b + 1])
        sq_x4 = build_ckks_mul_relin_rescale(context, ids[b + 1],
                                             square=True)
        mul_w = build_ckks_mul_relin_rescale(context, ids[b + 2])
        c0, c1, c2, c3 = coeffs
        sigma_x2 = sigma_x * sigma_x / q[b]                 # level b+1
        sigma_x3 = sigma_x2 * sigma_x / q[b + 1]            # level b+2
        sigma_x4 = sigma_x2 * sigma_x2 / q[b + 1]           # level b+2
        sigma_hi = Dl * Dl
        pt_c2 = _enc(c2, sigma_hi / sigma_x, b + 2)
        pt_c3 = _enc(c3, sigma_hi / sigma_x3, b + 2)
        sigma_w = sigma_hi * sigma_x4 / q[b + 2]            # level b+3
        pt_c0 = _enc(c0, sigma_w / sigma_x, b + 3)
        pt_c1 = _enc(c1, sigma_w / sigma_x3, b + 3)
        sigma_out = sigma_w / q[b + 3]                      # level b+4
        cd3 = cds[b + 3]

        def stage(x, relin_key):
            x2 = sq_x2(x, relin_key)                        # level b+1
            x1 = x[..., : Ls[b + 1], :]
            x3 = mul_x3(x2, x1, relin_key)                  # level b+2
            x4 = sq_x4(x2, relin_key)                       # level b+2
            lim2, lim3 = limbs[b + 2], limbs[b + 3]
            x_2 = x[..., : Ls[b + 2], :]
            hi = add_poly(
                jnp.stack([dyadic_product(x_2[..., c, :, :], pt_c2, lim2)
                           for c in range(2)], axis=-3),
                jnp.stack([dyadic_product(x3[..., c, :, :], pt_c3, lim2)
                           for c in range(2)], axis=-3), lim2)
            w = mul_w(x4, hi, relin_key)                    # level b+3
            x_3 = x[..., : Ls[b + 3], :]
            x3_3 = x3[..., : Ls[b + 3], :]
            lo = add_poly(
                jnp.stack([dyadic_product(x_3[..., c, :, :], pt_c0, lim3)
                           for c in range(2)], axis=-3),
                jnp.stack([dyadic_product(x3_3[..., c, :, :], pt_c1, lim3)
                           for c in range(2)], axis=-3), lim3)
            w = add_poly(w, lo, lim3)
            return divide_and_round_q_last_ntt(                # level b+4
                w, cd3.device_rns_tool, cd3.ntt_tables)

        return stage, sigma_out

    fns = []
    sigma = Dl
    for i, coeffs in enumerate(stages):
        fn_i, sigma = make_stage(4 * i, coeffs, sigma)
        fns.append(fn_i)

    def step(ct_a, relin_key):
        x = ct_a
        for fn_i in fns:
            x = fn_i(x, relin_key)
        return x

    return step, ids[n_levels], sigma


def _sign_gate(context: SealContext, scale: float, encoder, n_g: int,
               n_f: int, parms_id, what: str):
    """Shared closing-gate setup for the sign-derived ops (relu, max):
    the sign pipeline plus the level/scale bookkeeping of the ONE
    multiply that follows it — the ones-plaintext aligned to the sign
    output scale, the multiplier at the sign level, and the halved
    output scale (the /2 of (1 +- sign)/2 folds into out_scale)."""
    import numpy as np

    sign_fn, sign_pid, sign_scale = build_ckks_sign(
        context, scale, encoder, n_g=n_g, n_f=n_f, parms_id=parms_id)
    sign_cd = context.get_context_data(sign_pid)
    out_cd = sign_cd.next_context_data
    if out_cd is None:
        raise ValueError(f"modulus chain too short: {what} needs one more "
                         "level after sign")
    one_s = np.asarray(encoder.encode(1.0, sign_scale, sign_pid).data)
    mul_out = build_ckks_mul_relin_rescale(context, sign_pid)
    q_last = float(sign_cd.parms.coeff_modulus[-1].value)
    out_scale = 2.0 * sign_scale * float(scale) / q_last
    return sign_fn, sign_cd, out_cd, one_s, mul_out, out_scale


def build_ckks_relu(context: SealContext, scale: float, encoder,
                    n_g: int = 1, n_f: int = 2, parms_id=None):
    """Encrypted ReLU(a) = a * (1 + sign(a)) / 2 for slot values in
    [-1, 1]: the composite-sign pipeline plus ONE closing multiply with
    the (mod-switched) input; the /2 folds into the returned out_scale
    (decoding divides by it) so it costs nothing.

    4 * (n_g + n_f) + 1 levels.  Accuracy: exact to the sign resolution
    outside the gap; inside |a| < gap the output lies between 0 and a
    (the sign curve is monotone there).

    Returns (fn, out_parms_id, out_scale); fn(ct_a, relin_key).
    """
    if parms_id is None:
        parms_id = context.first_parms_id
    sign_fn, sign_cd, out_cd, one_s, mul_out, out_scale = _sign_gate(
        context, scale, encoder, n_g, n_f, parms_id, "relu")
    lim_s = sign_cd.limb_constants
    L_s = len(sign_cd.parms.coeff_modulus)

    def step(ct_a, relin_key):
        s = sign_fn(ct_a, relin_key)
        s0 = add_poly(s[..., 0, :, :], one_s, lim_s)    # 1 + sign(a)
        s1 = s[..., 1, :, :]
        gate = jnp.stack([s0, s1], axis=-3)
        return mul_out(ct_a[..., : L_s, :], gate, relin_key)

    return step, out_cd.parms_id, out_scale


def build_ckks_max(context: SealContext, scale: float, encoder,
                   n_g: int = 1, n_f: int = 2, parms_id=None):
    """Encrypted slotwise max(a, b) = ((a + b) + (a - b) * sign(a - b)) / 2
    — the maxpool/argmax primitive, built on the composite sign.

    Scale alignment without an extra level: the (a+b) branch rides a
    dyadic product with the all-ones plaintext encoded at the SIGN
    output's scale, then the same q_last rescale as the (a-b)*sign
    product, so both branches land at the identical scale and the /2
    folds into out_scale (cf. build_ckks_relu).

    Domain: |a - b| <= 1 (e.g. slot values in [-1/2, 1/2]); inside the
    sign resolution gap the output lies between a and b.
    4 * (n_g + n_f) + 1 levels.

    Returns (fn, out_parms_id, out_scale); fn(ct_a, ct_b, relin_key).
    """
    if parms_id is None:
        parms_id = context.first_parms_id
    in_limbs = context.get_context_data(parms_id).limb_constants
    sign_fn, sign_cd, out_cd, one_s, mul_out, out_scale = _sign_gate(
        context, scale, encoder, n_g, n_f, parms_id, "max")
    lim_s = sign_cd.limb_constants
    lim_o = out_cd.limb_constants
    L_s = len(sign_cd.parms.coeff_modulus)

    def step(ct_a, ct_b, relin_key):
        diff = sub_poly(ct_a, ct_b, in_limbs)
        s = sign_fn(diff, relin_key)
        v = mul_out(diff[..., : L_s, :], s, relin_key)
        tot = add_poly(ct_a[..., : L_s, :], ct_b[..., : L_s, :], lim_s)
        u = jnp.stack([dyadic_product(tot[..., c, :, :], one_s, lim_s)
                       for c in range(2)], axis=-3)
        u = divide_and_round_q_last_ntt(u, sign_cd.device_rns_tool,
                                        sign_cd.ntt_tables)
        return add_poly(u, v, lim_o)

    return step, out_cd.parms_id, out_scale


def build_ckks_matmul_square(context: SealContext, d: int, scale: float,
                             encoder, parms_id=None, heads: int = 1):
    """Encrypted matrix @ matrix for two d x d matrices packed row-major
    into d^2 slots (Jiang-Kim-Lauter-Song, CCS'18) — the encrypted
    linear-algebra primitive the per-op reference cannot express
    (evaluator.cpp stops at single rotations, :1945-2000).

        C = sum_{k=0}^{d-1} phi^k(sigma(A)) (*) psi^k(tau(B))

    sigma(A)[i,j] = A[i, (i+j) mod d] and tau(B)[i,j] = B[(i+j) mod d, j]
    are diagonal linear maps on the packed slot vector (2d-1 and d
    generalized diagonals), phi^k is the masked in-row column shift
    (2 diagonals), psi^k the pure row shift (ONE cyclic rotation by k*d —
    the reason for the row-major packing).  Total: 3 multiplicative
    levels and 3(d-1) distinct rotations for a d^3-work product.

    heads > 1 batches H INDEPENDENT d x d products in one ciphertext:
    head h packed in slots [h*d^2, (h+1)*d^2).  Every per-block linear
    map rides the same global rotations; the two maps whose row wrap the
    single-head layout absorbed into the mod-d^2 cycle (tau and psi^k)
    split into an in-block part and a wrapped part one block lower —
    tau grows to <= 2d-1 diagonals and each psi^k row shift becomes two
    rotations whose {0,1} block masks FOLD INTO the phi^k masks on the
    a-side (the contraction distributes a_k (*) (lo (*) b + hi (*) b')
    = (a_k lo) (*) b + (a_k hi) (*) b'), so the level count stays 3 and
    the contraction grows to <= 2d terms.  heads=1 keeps the original
    d-term dataflow bit-for-bit.

    Device schedule: sigma/tau ride the hoisted fused-moddown matvec; the
    k-loop's 2(d-1) + (d-1) shifts ride TWO hoisted mod-ups
    (build_ckks_rotate_many's stacked-table gather); the d ciphertext-
    ciphertext products are ONE exact 128-bit contraction over the k axis
    per output component; the degree-2 tail is relinearized ONCE.

    Requires heads*d*d == encoder.slots (pack smaller matrices by padding
    with zeros to the next power of two and using that d).  Input
    ciphertexts hold the packed matrices at `scale`; output holds packed
    C at out_scale = scale^2 * q1 / (q1 * q2) (the returned value), 3
    levels down.  Decrypt-equal (not bit-identical) across mask/product
    regroupings — same bounded-rounding argument as fused_moddown.

    Returns (fn, out_parms_id, out_scale); fn(ctA, ctB, rot_keys_stack,
    relin_key) with rot_keys_stack ordered by fn.rot_steps.
    """
    import numpy as np

    if parms_id is None:
        parms_id = context.first_parms_id
    s = encoder.slots
    if d < 2 or heads < 1 or heads * d * d != s:
        raise ValueError(
            f"need d >= 2 with heads*d*d == slots ({heads}*{d}^2 != {s})")
    P = d * d                                   # block (head) size

    ids = [parms_id]
    for _ in range(3):
        nxt = context.get_context_data(ids[-1]).next_context_data
        if nxt is None:
            raise ValueError("modulus chain too short: matmul needs 3 levels")
        ids.append(nxt.parms_id)
    cds = [context.get_context_data(i) for i in ids]
    limbs = [c.limb_constants for c in cds]
    q = [float(c.parms.coeff_modulus[-1].value) for c in cds]

    Dl = float(scale)
    u_idx = np.arange(s) % P                    # within-block offset
    i_idx = u_idx // d
    j_idx = u_idx % d

    # sigma: offset k (0..d-1) masks j < d-k rows i == k; offset k-d masks
    # the wrapped tail j >= d-k (both as {0,1} slot vectors).  Both
    # offsets stay in-block under the masks (j < d-k keeps u+k < P;
    # j >= d-k keeps u >= d-k), so the single-head steps tile verbatim.
    sigma_diags = {}
    for k in range(d):
        m_lo_s = ((i_idx == k) & (j_idx < d - k)).astype(float)
        if m_lo_s.any():
            sigma_diags[k] = m_lo_s.tolist()
        if k:
            m_hi_s = ((i_idx == k) & (j_idx >= d - k)).astype(float)
            sigma_diags[(k - d) % s] = m_hi_s.tolist()
    # tau: offset d*j selects column j.  Single-head: the row wrap is
    # absorbed by the cyclic rotation over s = P.  Multi-head: rows
    # i >= d-j would cross into the next block, so they ride the wrapped
    # offset d*j - P instead (one block lower).
    tau_diags = {}
    for j in range(d):
        if heads == 1:
            tau_diags[d * j] = (j_idx == j).astype(float).tolist()
            continue
        lo = ((j_idx == j) & (i_idx < d - j)).astype(float)
        if lo.any():
            tau_diags[d * j] = lo.tolist()
        if j:
            hi = ((j_idx == j) & (i_idx >= d - j)).astype(float)
            tau_diags[(d * j - P) % s] = hi.tolist()

    sigma_fn = build_ckks_matvec(context, sigma_diags, q[0], encoder,
                                 parms_id=ids[0])
    tau_fn = build_ckks_matvec(context, tau_diags, q[0], encoder,
                               parms_id=ids[0])

    # k-loop shifts at level 1, all hoisted.  A-side steps are block-safe
    # under the phi masks (same argument as sigma); B-side row shifts
    # need the wrapped twin (d*k - P) when heads > 1.
    stepsA = sorted({k for k in range(1, d)} | {s - d + k for k in range(1, d)})
    stepsB = sorted({d * k for k in range(1, d)}
                    | ({(d * k - P) % s for k in range(1, d)}
                       if heads > 1 else set()))
    rotA_fn = build_ckks_rotate_many(context, stepsA, parms_id=ids[1])
    rotB_fn = build_ckks_rotate_many(context, stepsB, parms_id=ids[1])
    posA = {st: r for r, st in enumerate(stepsA)}
    posB = {st: r for r, st in enumerate(stepsB)}

    # phi^k masks, encoded in NTT plaintext form at level 1, scale q1.
    # heads > 1 composes the psi^k block masks (i < d-k in place, i >=
    # d-k from the wrapped rotation) into the a-side masks.
    def _mask(pred):
        v = pred.astype(float).tolist()
        return np.asarray(encoder.encode(v, q[1], ids[1]).data)

    m_lo = np.stack([_mask(j_idx < d - k) for k in range(d)])
    m_hi = np.stack([_mask(j_idx >= d - k) for k in range(1, d)])
    if heads > 1:
        # phi^k (j-) masks intersected with psi^k's block (i-) masks:
        # _p pairs with the in-place row shift d*k, _w with the wrapped
        # twin d*k - P (k >= 1; psi^0 is the identity)
        m_lo_p = np.stack([_mask((j_idx < d - k) & (i_idx < d - k))
                           for k in range(d)])
        m_hi_p = np.stack([_mask((j_idx >= d - k) & (i_idx < d - k))
                           for k in range(1, d)])
        m_lo_w = np.stack([_mask((j_idx < d - k) & (i_idx >= d - k))
                           for k in range(1, d)])
        m_hi_w = np.stack([_mask((j_idx >= d - k) & (i_idx >= d - k))
                           for k in range(1, d)])

    # master key order: union of every consumer's sorted step set
    rot_steps = sorted(set(sorted(sigma_diags) + list(tau_diags))
                       | set(stepsA) | set(stepsB))
    rot_steps = [st for st in rot_steps if st != 0]
    midx = {st: i for i, st in enumerate(rot_steps)}
    idx_sigma = np.asarray([midx[st] for st in sorted(sigma_diags) if st != 0])
    idx_tau = np.asarray([midx[st] for st in sorted(tau_diags) if st != 0])
    idx_A = np.asarray([midx[st] for st in stepsA])
    idx_B = np.asarray([midx[st] for st in stepsB])

    relin_plan = KeySwitchPlan(context, ids[1])

    def _rescale(ct, lvl):
        c = cds[lvl]
        return divide_and_round_q_last_ntt(ct, c.device_rns_tool,
                                           c.ntt_tables)

    def step(ctA, ctB, rot_keys_stack, relin_key):
        sA = _rescale(sigma_fn(ctA, rot_keys_stack[idx_sigma]), 0)
        tB = _rescale(tau_fn(ctB, rot_keys_stack[idx_tau]), 0)
        rA = rotA_fn(sA, rot_keys_stack[idx_A])     # [RA, ..., 2, L1, N]
        rB = rotB_fn(tB, rot_keys_stack[idx_B])     # [RB, ..., 2, L1, N]
        lim = limbs[1]

        def masked(base, mask, wrap=None, wmask=None):
            ak = jnp.stack([
                dyadic_product(base[..., c, :, :], mask, lim)
                for c in range(2)], axis=-3)
            if wrap is not None:
                hk = jnp.stack([
                    dyadic_product(wrap[..., c, :, :], wmask, lim)
                    for c in range(2)], axis=-3)
                ak = add_poly(ak, hk, lim)
            return ak

        # masked column shifts: a_k = m_lo[k] (*) rot_k(sA) + m_hi[k] (*)
        # rot_{k-d}(sA)   (k = 0 is the unshifted row, low mask only)
        if heads == 1:
            a_parts = []
            for k in range(d):
                base = sA if k == 0 else rA[posA[k]]
                wrap = rA[posA[s - d + k]] if k else None
                a_parts.append(masked(base, m_lo[k], wrap,
                                      m_hi[k - 1] if k else None))
            b_parts = [tB] + [rB[posB[d * k]] for k in range(1, d)]
        else:
            # per-head products: psi^k splits into the in-place shift
            # d*k and its wrapped twin d*k - P; the {0,1} block masks
            # fold into the a-side (<= 2d contraction terms)
            a_parts, b_parts = [], []
            for k in range(d):
                base = sA if k == 0 else rA[posA[k]]
                wrap = rA[posA[s - d + k]] if k else None
                a_parts.append(masked(base, m_lo_p[k], wrap,
                                      m_hi_p[k - 1] if k else None))
                b_parts.append(tB if k == 0 else rB[posB[d * k]])
                if k:
                    a_parts.append(masked(base, m_lo_w[k - 1], wrap,
                                          m_hi_w[k - 1]))
                    b_parts.append(rB[posB[(d * k - P) % s]])

        # C (degree 2) = sum_k a_k (*) b_k — one 128-bit contraction over
        # the k axis per output component (2d - 1 terms when heads > 1)
        T = len(a_parts)
        p0 = modops.accumulate_mulmod_128(
            ((a_parts[k][..., 0, :, :], b_parts[k][..., 0, :, :])
             for k in range(T)), lim.p, lim.ratio0, lim.ratio1)
        p1 = modops.accumulate_mulmod_128(
            ((a_parts[k][..., c, :, :], b_parts[k][..., 1 - c, :, :])
             for k in range(T) for c in range(2)),
            lim.p, lim.ratio0, lim.ratio1)
        p2 = modops.accumulate_mulmod_128(
            ((a_parts[k][..., 1, :, :], b_parts[k][..., 1, :, :])
             for k in range(T)), lim.p, lim.ratio0, lim.ratio1)

        # ONE relinearization of the shared degree-2 tail, then the two
        # closing rescales (q1: the mask scale, q2: one product prime)
        ct_k = compute_modup_digits(p2, relin_plan, True)
        d0, d1 = keyswitch_inner_product(ct_k, relin_key, relin_plan, True)
        out = jnp.stack([add_poly(p0, d0, lim), add_poly(p1, d1, lim)],
                        axis=-3)
        return _rescale(_rescale(out, 1), 2)

    step.rot_steps = rot_steps
    out_scale = (Dl * Dl * q[1]) / (q[1] * q[2])
    return step, ids[3], out_scale


def attention_plan(d: int, msg_bound: float = 0.5, exp_degree: int = 4,
                   iters: int = None, recip_target: float = 1e-5):
    """Level/accuracy plan for `build_ckks_attention`.

    With Q/K/V slot values in [-msg_bound, msg_bound], the logits are
    bounded by B = sqrt(d) * msg_bound^2, so the softmax denominator
    rowsum lies in [d*e^-B, d*e^B] and the Goldschmidt seed error after
    the range reduction R = (rmin + rmax)/2 is |e_0| <= tanh(B).  When
    `iters` is None the smallest m with tanh(B)^(2^(m+1)) <= recip_target
    is chosen (a * x_m = 1 - e_0^(2^(m+1)), build_ckks_inverse).

    Returns (n_levels, iters, logit_bound):
    n_levels = 3 (QK^T) + exp_degree-1 (exp chain) + 1 (exp realign)
    + 1 (rowsum) + iters+1 (reciprocal) + 1 (P = E*recip)
    + 1 (P realign) + 3 (P @ V) = exp_degree + iters + 10.
    """
    import math as _math

    B = _math.sqrt(d) * msg_bound * msg_bound
    if iters is None:
        e0 = _math.tanh(B)
        m = 1
        while e0 ** (2 ** (m + 1)) > recip_target:
            m += 1
        iters = m
    return exp_degree + iters + 10, iters, B


def build_ckks_attention(context: SealContext, d: int, scale: float,
                         encoder, msg_bound: float = 0.5, iters: int = None,
                         exp_mode: str = "cheby", exp_degree: int = 4,
                         recip_target: float = 1e-5, parms_id=None,
                         heads: int = 1):
    """Encrypted attention: softmax(Q @ K^T / sqrt(d)) @ V
    with Q, K^T, V ALL encrypted (d x d row-major packed, K supplied
    pre-transposed by the client — transposition is a client-side slot
    permutation at packing time).  heads > 1 packs H INDEPENDENT heads
    as contiguous d^2-slot blocks (heads*d*d == slots) and runs ALL of
    them in the one pipeline: the matmuls ride the block-masked JKLS
    schedule (build_ckks_matmul_square heads>1), and every softmax stage
    (exp, rowsum, Goldschmidt) is slot-local or j-masked, so it is
    head-oblivious by construction — multi-head self-attention for the
    cost of one ciphertext chain.  No reference analogue at any layer:
    it composes three capabilities the per-op reference cannot express —
    the JKLS encrypted matmul, an encrypted row-wise softmax (polynomial
    exp with 1/sqrt(d) folded into the coefficients, a masked
    block-rowsum matvec with the Goldschmidt range reduction folded into
    its 0/1 diagonals, and the Goldschmidt reciprocal), and a second
    encrypted matmul — into ONE composed pipeline of jitted stages.

    Level cost (see `attention_plan`): exp_degree + iters + 10; the
    historical deg-4 shape is 14 + iters.

    Accuracy contract: slot values of Q, K, V within [-msg_bound,
    msg_bound]; the logits then satisfy |S|/sqrt(d) <= B = sqrt(d) *
    msg_bound^2.  exp_mode picks the exp approximant over that window:
    - "cheby" (default): degree-`exp_degree` Chebyshev interpolant of
      exp(s/sqrt(d)) fitted over the ACTUAL raw-logit range
      [-d*msg_bound^2, d*msg_bound^2] — near-minimax, so the window
      widens with d instead of being pinned at the Taylor ~0.8 radius
      (deg-4 interpolation error ~ (B/2)^5/60 at the window edge).
    - "taylor": the legacy degree-4 Maclaurin series (valid |logit|
      <= ~0.8 only; kept for comparison runs).
    `iters=None` auto-sizes the Goldschmidt chain from tanh(B) so the
    reciprocal's relative error is <= recip_target (attention_plan).

    Returns (run, out_parms_id, out_scale, rot_steps):
    run(ctQ, ctKT, ctV, rot_keys_stack, relin_key) — Q/K^T/V encrypted
    at `scale` at the top of the chain; rot_keys_stack stacked for
    `rot_steps` (the union over both matmuls and the rowsum map).
    """
    import math as _math

    import jax
    import numpy as np

    from ..ops.rnsops import divide_and_round_q_last_ntt

    if parms_id is None:
        parms_id = context.first_parms_id
    s = encoder.slots
    if heads * d * d != s:
        raise ValueError(f"need heads*d*d == slots ({heads}*{d}^2 != {s})")
    Dl = float(scale)
    _, iters, _B = attention_plan(d, msg_bound, exp_degree, iters,
                                  recip_target)

    # ---- stage 1: S = Q @ K^T (3 levels) ---------------------------------
    mm1, pid_s, sc_s = build_ckks_matmul_square(
        context, d, Dl, encoder, parms_id=parms_id, heads=heads)

    # ---- stage 2: E = exp(S / sqrt(d)) (exp_degree - 1 levels) ------------
    a = 1.0 / _math.sqrt(d)
    if exp_mode == "cheby":
        Bs = d * msg_bound * msg_bound       # raw-logit (QK^T entry) bound
        ch = np.polynomial.chebyshev.Chebyshev.interpolate(
            lambda t, _a=a: np.exp(_a * t), exp_degree, domain=[-Bs, Bs])
        exp_coeffs = ch.convert(kind=np.polynomial.polynomial.Polynomial
                                ).coef.tolist()
    elif exp_mode == "taylor":
        if exp_degree != 4:
            raise ValueError("taylor mode is the pinned legacy degree-4")
        exp_coeffs = [a ** k / _math.factorial(k) for k in range(5)]
    else:
        raise ValueError(f"unknown exp_mode {exp_mode!r}")
    exp_fn, pid_e70, sc_e70 = build_ckks_poly_eval(
        context, exp_coeffs, sc_s, encoder, parms_id=pid_s)

    # poly_eval lands at ~scale^2 (its linear-combination convention);
    # ONE value-preserving realignment brings E back to exactly Dl so
    # the rowsum masks encode at full precision and the Goldschmidt
    # scale track stays stationary (same trick as examples/ex14).
    cd_e70 = context.get_context_data(pid_e70)
    q_e70 = float(cd_e70.parms.coeff_modulus[-1].value)
    pt_align_e = np.asarray(
        encoder.encode(1.0, Dl * q_e70 / sc_e70, pid_e70).data)
    limbs_e70 = cd_e70.limb_constants
    pid_e = cd_e70.next_context_data.parms_id
    sc_e = Dl
    cd_e = context.get_context_data(pid_e)

    def stage_align_e(e_ct):
        x = jnp.stack([
            dyadic_product(e_ct[..., 0, :, :], pt_align_e, limbs_e70),
            dyadic_product(e_ct[..., 1, :, :], pt_align_e, limbs_e70),
        ], axis=-3)
        return divide_and_round_q_last_ntt(
            x, cd_e70.device_rns_tool, cd_e70.ntt_tables)

    # ---- stage 3: rowsum/R — block-local masked matvec (1 level) ----------
    bx = _math.sqrt(d) * msg_bound * msg_bound
    rmin, rmax = d * _math.exp(-bx), d * _math.exp(bx)
    R = 0.5 * (rmin + rmax)
    i_idx = np.arange(s) // d
    j_idx = np.arange(s) % d
    rs_diags = {}
    for o in range(d):
        lo = ((j_idx + o) < d).astype(float) / R     # stay in row
        hi = ((j_idx + o) >= d).astype(float) / R    # wrapped part
        if lo.any():
            rs_diags[o] = lo.tolist()
        if o and hi.any():
            rs_diags[o - d] = hi.tolist()
    q_e = float(cd_e.parms.coeff_modulus[-1].value)
    rs_fn = build_ckks_matvec(context, rs_diags, q_e, encoder,
                              parms_id=pid_e)
    pid_r = cd_e.next_context_data.parms_id
    sc_r = sc_e                                       # scale-preserving

    def stage_rowsum(e_ct, keys):
        out = rs_fn(e_ct, keys)
        return divide_and_round_q_last_ntt(
            out, cd_e.device_rns_tool, cd_e.ntt_tables)

    # ---- stage 4: recip = R / rowsum (iters + 1 levels) --------------------
    inv_fn, pid_i, sc_i = build_ckks_inverse(
        context, sc_r, encoder, iters=iters, parms_id=pid_r)
    cd_i = context.get_context_data(pid_i)
    L_i = len(cd_i.parms.coeff_modulus)

    # ---- stage 5: P = E * recip (1 level); values R * softmax --------------
    mul_p = build_ckks_mul_relin_rescale(context, pid_i)
    q_i = float(cd_i.parms.coeff_modulus[-1].value)
    pid_p = cd_i.next_context_data.parms_id
    sc_p = sc_e * sc_i / q_i

    # ---- stage 6: realign P to exactly Dl (1 level) ------------------------
    cd_p = context.get_context_data(pid_p)
    L_p = len(cd_p.parms.coeff_modulus)
    q_p = float(cd_p.parms.coeff_modulus[-1].value)
    pt_align = np.asarray(
        encoder.encode(1.0, Dl * q_p / sc_p, pid_p).data)
    pid_p2 = cd_p.next_context_data.parms_id
    limbs_p = cd_p.limb_constants

    def stage_align(p_ct):
        x = jnp.stack([
            dyadic_product(p_ct[..., 0, :, :], pt_align, limbs_p),
            dyadic_product(p_ct[..., 1, :, :], pt_align, limbs_p),
        ], axis=-3)
        return divide_and_round_q_last_ntt(
            x, cd_p.device_rns_tool, cd_p.ntt_tables)

    # ---- stage 7: out = P @ V (3 levels); fold 1/R into out_scale ----------
    mm2, pid_o, sc_o = build_ckks_matmul_square(
        context, d, Dl, encoder, parms_id=pid_p2, heads=heads)
    L_p2 = len(context.get_context_data(pid_p2).parms.coeff_modulus)
    out_scale = sc_o * R                  # values carry R*softmax @ V

    # ---- rotation-key plumbing: one global stack ---------------------------
    step_set = set(mm1.rot_steps) | set(mm2.rot_steps)
    step_set |= {st for st in rs_diags if st != 0}
    rot_steps = sorted(step_set)
    sidx = {st: i for i, st in enumerate(rot_steps)}
    idx_mm1 = np.asarray([sidx[st] for st in mm1.rot_steps], dtype=np.int64)
    idx_mm2 = np.asarray([sidx[st] for st in mm2.rot_steps], dtype=np.int64)
    rs_steps = [st for st in sorted(rs_diags) if st != 0]
    idx_rs = np.asarray([sidx[st] for st in rs_steps], dtype=np.int64)

    j_mm1 = jax.jit(mm1)
    j_exp = jax.jit(lambda x, rk: stage_align_e(
        exp_fn(x, rk, jnp.zeros((0,), jnp.uint64))))
    j_rowsum = jax.jit(stage_rowsum)
    j_inv = jax.jit(inv_fn)
    j_p = jax.jit(lambda e, v, rk: mul_p(e[..., :L_i, :], v, rk))
    j_align = jax.jit(stage_align)
    j_mm2 = jax.jit(lambda p, v, ks, rk: mm2(p, v[..., :L_p2, :], ks, rk))

    def run(ctQ, ctKT, ctV, rot_keys_stack, relin_key):
        S = j_mm1(ctQ, ctKT, rot_keys_stack[idx_mm1], relin_key)
        E = j_exp(S, relin_key)
        rsum = j_rowsum(E, rot_keys_stack[idx_rs])
        recip = j_inv(rsum, relin_key)
        P = j_p(E, recip, relin_key)
        P = j_align(P)
        return j_mm2(P, ctV, rot_keys_stack[idx_mm2], relin_key)

    return run, pid_o, out_scale, rot_steps
