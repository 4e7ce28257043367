"""ctypes bindings for the native runtime module (native/gst_native.cpp).

Loads gemini_seal/_gst_native.so when present (build with
tools/build_native.sh); falls back to None so pure-Python paths keep
working.  The reference keeps these components native too (blake2b.c,
randomgen.cpp); here they accelerate the host-side PRNG stream that feeds
key generation and seeded-ciphertext expansion.
"""

from __future__ import annotations

import ctypes
import os
import warnings
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _try_build(path: str) -> None:
    """Best-effort on-demand build (the .so is a build artifact, not vendored).

    The pure-Python blake2xb fallback is ~50x slower, which turns keygen at
    N=8192 into minutes; a 2-second g++ invocation avoids that for any fresh
    checkout that has a toolchain.
    """
    import subprocess

    src = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
        "native",
        "gst_native.cpp",
    )
    if not os.path.exists(src):
        return
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             src, "-lz", "-o", path],
            check=True,
            capture_output=True,
            text=True,
            timeout=120,
        )
    except subprocess.CalledProcessError as e:
        warnings.warn(f"building the native module failed; host keygen and "
                      f"encryption fall back to pure Python (~50x slower):\n"
                      f"{e.stderr}", RuntimeWarning, stacklevel=3)
    except (OSError, subprocess.TimeoutExpired) as e:
        warnings.warn(f"cannot build the native module ({e}); host keygen "
                      f"and encryption fall back to pure Python (~50x "
                      f"slower)", RuntimeWarning, stacklevel=3)


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_gst_native.so")
    src = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
        "native", "gst_native.cpp",
    )
    stale = (
        os.path.exists(path) and os.path.exists(src)
        and os.path.getmtime(path) < os.path.getmtime(src)
    )
    if not os.path.exists(path) or stale:
        _try_build(path)
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.gst_blake2xb.restype = ctypes.c_int
        lib.gst_blake2xb.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64,
            ctypes.c_void_p, ctypes.c_uint64,
            ctypes.c_void_p, ctypes.c_uint64,
        ]
        lib.gst_prng_fill.restype = ctypes.c_int
        lib.gst_prng_fill.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64,
        ]
        lib.gst_frame_bound.restype = ctypes.c_int64
        lib.gst_frame_bound.argtypes = [ctypes.c_uint64]
        lib.gst_frame.restype = ctypes.c_int64
        lib.gst_frame.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
        ]
        lib.gst_unframe.restype = ctypes.c_int64
        lib.gst_unframe.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
        ]
        lib.gst_ntt_forward.restype = None
        lib.gst_ntt_forward.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.gst_ntt_inverse.restype = None
        lib.gst_ntt_inverse.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int,
        ]
        lib.gst_crt_compose.restype = None
        lib.gst_crt_compose.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_uint64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.gst_decompose_rounded.restype = None
        lib.gst_decompose_rounded.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
        ]
        lib.gst_crt_centered_double.restype = None
        lib.gst_crt_centered_double.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_uint64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double,
        ]
        _LIB = lib
    except (OSError, AttributeError):
        # missing file or a stale .so lacking newer symbols
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def blake2xb(out_len: int, data: bytes, key: bytes = b"") -> Optional[bytes]:
    lib = _load()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(out_len)
    rc = lib.gst_blake2xb(
        out, out_len, data, len(data), key if key else None, len(key)
    )
    if rc != 0:
        raise RuntimeError("gst_blake2xb failed")
    return out.raw


def prng_fill(nblocks: int, seed, counter_start: int) -> Optional[bytes]:
    """nblocks consecutive 4096-byte BlakePRNG buffers."""
    lib = _load()
    if lib is None:
        return None
    nbytes = nblocks * 4096
    out = ctypes.create_string_buffer(nbytes)
    seed_arr = np.array(seed, dtype=np.uint64)
    rc = lib.gst_prng_fill(
        out, nbytes, seed_arr.ctypes.data_as(ctypes.c_void_p), counter_start
    )
    if rc != 0:
        raise RuntimeError("gst_prng_fill failed")
    return out.raw


def frame(payload: bytes, compr_mode: int) -> Optional[bytes]:
    """SEALHeader framing (+deflate) in the native runtime; byte-identical
    to the Python path."""
    lib = _load()
    if lib is None:
        return None
    cap = lib.gst_frame_bound(len(payload))
    out = ctypes.create_string_buffer(cap)
    n = lib.gst_frame(out, payload, len(payload), compr_mode)
    if n < 0:
        raise RuntimeError("gst_frame failed")
    return out.raw[:n]


def unframe(data: bytes, out_cap_hint: int = 0) -> Optional[bytes]:
    """Unframe + inflate in the native runtime.  Returns the payload."""
    lib = _load()
    if lib is None:
        return None
    cap = max(out_cap_hint, 4 * len(data) + 1024)
    while True:
        out = ctypes.create_string_buffer(cap)
        n = lib.gst_unframe(out, cap, data, len(data))
        if n == -2:
            cap *= 4
            continue
        if n < 0:
            raise ValueError("loaded SEALHeader is invalid")
        return out.raw[:n]


def _ptr(a: np.ndarray):
    import ctypes

    return a.ctypes.data_as(ctypes.c_void_p)


def ntt_forward(x: np.ndarray, w, ws, mods, canonical: bool):
    """In-place-on-a-copy host forward NTT over [..., L, n]; returns the
    transformed array, or None when the native module is unavailable.
    Bit-identical to ops.ntt.ntt_forward(_lazy)."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.uint64).copy()
    L, n = x.shape[-2], x.shape[-1]
    rows = int(np.prod(x.shape[:-2], dtype=np.int64)) if x.ndim > 2 else 1
    w = np.ascontiguousarray(w, dtype=np.uint64)
    ws = np.ascontiguousarray(ws, dtype=np.uint64)
    mods = np.ascontiguousarray(mods, dtype=np.uint64)
    lib.gst_ntt_forward(
        _ptr(x), rows, L, n.bit_length() - 1, _ptr(w), _ptr(ws), _ptr(mods),
        1 if canonical else 0,
    )
    return x


def ntt_inverse(x: np.ndarray, w, ws, inv_n, inv_n_s, mods, canonical: bool):
    """Host inverse NTT (reordered twiddles, folded n^-1), or None."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.uint64).copy()
    L, n = x.shape[-2], x.shape[-1]
    rows = int(np.prod(x.shape[:-2], dtype=np.int64)) if x.ndim > 2 else 1
    w = np.ascontiguousarray(w, dtype=np.uint64)
    ws = np.ascontiguousarray(ws, dtype=np.uint64)
    inv_n = np.ascontiguousarray(inv_n, dtype=np.uint64)
    inv_n_s = np.ascontiguousarray(inv_n_s, dtype=np.uint64)
    mods = np.ascontiguousarray(mods, dtype=np.uint64)
    lib.gst_ntt_inverse(
        _ptr(x), rows, L, n.bit_length() - 1, _ptr(w), _ptr(ws),
        _ptr(inv_n), _ptr(inv_n_s), _ptr(mods), 1 if canonical else 0,
    )
    return x


def crt_centered_double(residues: np.ndarray, inv_punc, mods, qhat, qprod,
                        upper, nwords: int, inv_scale: float):
    """Fused CKKS decode ladder: [L, n] residues -> centered f64[n]
    (compose + centered lift + LSB-first double ladder, bit-exact with
    the mplimb path); or None when the native module is unavailable."""
    lib = _load()
    if lib is None:
        return None
    residues = np.ascontiguousarray(residues, dtype=np.uint64)
    L, n = residues.shape
    out = np.empty(n, dtype=np.float64)
    lib.gst_crt_centered_double(
        _ptr(out), _ptr(residues), n, L, nwords,
        _ptr(np.ascontiguousarray(inv_punc, dtype=np.uint64)),
        _ptr(np.ascontiguousarray(mods, dtype=np.uint64)),
        _ptr(np.ascontiguousarray(qhat, dtype=np.uint64)),
        _ptr(np.ascontiguousarray(qprod, dtype=np.uint64)),
        _ptr(np.ascontiguousarray(upper, dtype=np.uint64)),
        float(inv_scale),
    )
    return out


def crt_compose(residues: np.ndarray, inv_punc, mods, qhat, qprod,
                nwords: int):
    """[L, n] residues -> [K, n] limb planes of v in [0, q); or None."""
    lib = _load()
    if lib is None:
        return None
    residues = np.ascontiguousarray(residues, dtype=np.uint64)
    L, n = residues.shape
    out = np.empty((nwords, n), dtype=np.uint64)
    lib.gst_crt_compose(
        _ptr(out), _ptr(residues), n, L, nwords,
        _ptr(np.ascontiguousarray(inv_punc, dtype=np.uint64)),
        _ptr(np.ascontiguousarray(mods, dtype=np.uint64)),
        _ptr(np.ascontiguousarray(qhat, dtype=np.uint64)),
        _ptr(np.ascontiguousarray(qprod, dtype=np.uint64)),
    )
    return out


def decompose_rounded(rounded: np.ndarray, mods, pow2: np.ndarray):
    """Exact RNS residues of integer-valued doubles; [L, n] or None."""
    lib = _load()
    if lib is None:
        return None
    rounded = np.ascontiguousarray(rounded, dtype=np.float64)
    pow2 = np.ascontiguousarray(pow2, dtype=np.uint64)
    mods = np.ascontiguousarray(mods, dtype=np.uint64)
    L = mods.shape[0]
    n = rounded.shape[0]
    out = np.empty((L, n), dtype=np.uint64)
    lib.gst_decompose_rounded(
        _ptr(out), _ptr(rounded), n, L, _ptr(mods), _ptr(pow2), pow2.shape[1]
    )
    return out
