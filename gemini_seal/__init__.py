"""gemini_seal: homomorphic encryption on accelerators, in JAX.

A from-scratch JAX/XLA implementation of the BFV and CKKS RLWE schemes
with the capabilities of the reference C++ library (Microsoft SEAL 3.5 +
the Alibaba Gemini-Lab fork's Shoup-NTT and hybrid multi-special-prime
key-switching), re-architected for batched device execution:

- ciphertexts are dense uint64[size, L, N] device tensors,
- the polynomial/RNS kernels are plain jax.numpy programs that XLA
  compiles and fuses (exact 64-bit integer arithmetic, no floating point
  on the device), and
- scale-out over device meshes uses jax.sharding + collectives — limb (RNS)
  parallelism, coefficient (four-step NTT) parallelism, and ciphertext-batch
  data parallelism, none of which exist in the single-threaded reference.
"""

import jax as _jax

# 64-bit residue arithmetic everywhere: the framework requires x64 mode.
_jax.config.update("jax_enable_x64", True)

from .modulus import (  # noqa: E402
    CoeffModulus,
    Modulus,
    PlainModulus,
    SecLevelType,
)
from .params import EncryptionParameters, SchemeType  # noqa: E402
from .context import SealContext  # noqa: E402
from .ciphertext import Ciphertext, Plaintext  # noqa: E402
from .keys import (  # noqa: E402
    GaloisKeys,
    KSwitchKeys,
    PublicKey,
    RelinKeys,
    SecretKey,
)
from .keygenerator import KeyGenerator  # noqa: E402
from .encryptor import Encryptor  # noqa: E402
from .decryptor import Decryptor  # noqa: E402
from .evaluator import Evaluator  # noqa: E402
from .encoders import BatchEncoder, CKKSEncoder, IntegerEncoder  # noqa: E402
from .biguint import BigUInt  # noqa: E402
from .serialization import (  # noqa: E402
    SerializableCiphertext,
    SerializableKSwitchKeys,
)
from .models.device_evaluator import DeviceEvaluator  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "CoeffModulus",
    "Modulus",
    "PlainModulus",
    "SecLevelType",
    "EncryptionParameters",
    "SchemeType",
    "SealContext",
    "Ciphertext",
    "Plaintext",
    "SecretKey",
    "PublicKey",
    "KSwitchKeys",
    "RelinKeys",
    "GaloisKeys",
    "KeyGenerator",
    "Encryptor",
    "Decryptor",
    "Evaluator",
    "BatchEncoder",
    "CKKSEncoder",
    "IntegerEncoder",
    "BigUInt",
    "SerializableCiphertext",
    "SerializableKSwitchKeys",
    "DeviceEvaluator",
]
