"""Serving runtime: wire-format ingress -> jitted pipeline -> egress.

The reference is a library — callers write their own server loop around
eager C++ ops.  Here the serving unit is a compiled XLA program over
batched ciphertext tensors, so the runtime's job is the glue around it:

- INGRESS: SEAL-wire ciphertext blobs (from any SEAL client, any
  language — the byte-compatible format is the foreign-host boundary,
  COMPONENTS.md §2.3) are validated, deserialized, and stacked into the
  [B, size, L, N] batch tensor the pipelines consume;
- EXECUTE: a caller-supplied jittable step (anything from
  models.pipelines — matvec, dense layer, MLP, mul+relin+rescale chains)
  runs once over the whole batch, keys passed as device-resident
  operands;
- EGRESS: results come back as wire blobs (optionally deflated), sized
  up front via serialization.save_size.

Padding: batches are padded (by repeating the last element) up to the
compiled batch size so ONE executable serves any request size <= max
without recompilation; only the real results are returned.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

from .. import serialization as ser
from ..ciphertext import Ciphertext
from ..context import SealContext

__all__ = ["EncryptedComputeServer"]


class EncryptedComputeServer:
    """Batched encrypted-compute endpoint around one jitted pipeline.

    step: fn(ct_batch, *key_args) -> u64[B, 2, L_out, N]
    key_args: key tensors (galois stacks, relin keys, ...) uploaded once.
    out_parms_id / out_is_ntt / out_scale: metadata of the step's output
    ciphertexts (from the pipeline builder).
    batch_size: the compiled batch; requests are padded up to it.
    """

    def __init__(self, context: SealContext, step: Callable, key_args,
                 out_parms_id, out_is_ntt: bool, out_scale: float,
                 batch_size: int, validate: bool = True,
                 compr_mode: int = ser.COMPR_NONE, n_inputs: int = 1):
        import jax

        self.context = context
        self.batch_size = int(batch_size)
        self.out_parms_id = out_parms_id
        self.out_is_ntt = bool(out_is_ntt)
        self.out_scale = float(out_scale)
        self.validate = validate
        self.compr_mode = compr_mode
        self.n_inputs = int(n_inputs)   # ciphertext operands per request
        self._keys = [jax.device_put(np.asarray(k)) for k in key_args]
        self._step = jax.jit(step)

    def warm(self, example_request) -> None:
        """Compile the pipeline ahead of traffic with one example request
        (a blob, or a tuple of n_inputs blobs for multi-operand servers)."""
        self.submit([example_request])

    def submit(self, ct_blobs: Sequence) -> List[bytes]:
        """Run the pipeline over a batch of wire-format ciphertexts and
        return the results as wire-format blobs (same order).

        With n_inputs == 1 each request is one blob; with n_inputs > 1
        each request is a TUPLE of blobs, one per ciphertext operand
        (e.g. (A, B) pairs for the encrypted matmul endpoint) — the
        step receives one stacked batch tensor per operand position."""
        n_real = len(ct_blobs)
        if n_real == 0:
            return []
        batches = self._ingest(ct_blobs)
        return self._egress(n_real, self._step(*batches, *self._keys))

    # ---- pipelined ingress/compute overlap --------------------------------

    def _ingest(self, ct_blobs):
        """Wire blobs -> stacked host batch tensors (validation included).
        Seed-compressed Serializable ciphertexts (ser.SerializableCiphertext
        — ~half the wire bytes) expand transparently here."""
        n_real = len(ct_blobs)
        if n_real > self.batch_size:
            raise ValueError(
                f"batch of {n_real} exceeds compiled batch_size "
                f"{self.batch_size}; split the request")
        if self.n_inputs == 1:
            reqs = [(b,) for b in ct_blobs]
        else:
            for r in ct_blobs:
                if isinstance(r, (bytes, bytearray)):
                    raise ValueError(
                        f"this server takes {self.n_inputs} ciphertext "
                        f"blobs per request — pass tuples, not bare blobs")
            reqs = [tuple(r) for r in ct_blobs]
            for r in reqs:
                if len(r) != self.n_inputs:
                    raise ValueError(
                        f"each request needs {self.n_inputs} ciphertext "
                        f"blobs, got {len(r)}")
        batches = []
        for j in range(self.n_inputs):
            cts = [ser.load_ciphertext(r[j], self.context,
                                       validate=self.validate)
                   for r in reqs]
            p0 = cts[0].parms_id
            for ct in cts:
                if ct.parms_id != p0:
                    raise ValueError("batch ciphertexts must share a level")
            rows = [np.asarray(ct.data) for ct in cts]
            rows += [rows[-1]] * (self.batch_size - n_real)
            batches.append(np.stack(rows))
        return batches

    def _egress(self, n_real, out_dev):
        out = np.asarray(out_dev)           # blocks on batch completion
        return [
            ser.save(Ciphertext(out[i], self.out_parms_id, self.out_is_ntt,
                                self.out_scale), self.compr_mode)
            for i in range(n_real)
        ]

    def submit_stream(self, request_batches):
        """Pipelined submit: yields each batch's result blobs in order
        while the NEXT batch's host-side deserialization, device upload
        (jax.device_put is asynchronous) and compute dispatch proceed
        under the previous batch's execution — double-buffering the
        host-side work and the host<->device copies against the XLA
        program (outputs are identical to per-batch submit()).

        request_batches: iterable of blob-lists (each as submit takes).
        """
        import jax

        prev = None
        for blobs in request_batches:
            n_real = len(blobs)
            if n_real == 0:
                continue
            dev = [jax.device_put(b) for b in self._ingest(blobs)]
            out_dev = self._step(*dev, *self._keys)  # async dispatch
            if prev is not None:
                yield self._egress(*prev)
            prev = (n_real, out_dev)
        if prev is not None:
            yield self._egress(*prev)
