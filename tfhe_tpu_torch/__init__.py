"""tfhe_tpu_torch — the TFHE framework on PyTorch and CUDA (port of ``tfhe_tpu``).

The same scheme, layouts and bit-exact u32 arithmetic as the JAX package,
written as plain functions on torch tensors (u32 carried as wrapping int32,
``ops/torus.py``), with hand-written Hopper kernels for the blind rotation
(``csrc/``, built at first use into ``build/tfhe_tpu_torch/``).  It imports
neither JAX nor ``tfhe_tpu``.

Quick start::

    import numpy as np, torch, tfhe_tpu_torch as tfhe
    params = tfhe.get_params("default_128")
    ck, sk = tfhe.keygen(params, torch.Generator().manual_seed(0), device="cuda")
    a = tfhe.encrypt(ck, np.array([1, 0, 1]), 1)
    b = tfhe.encrypt(ck, np.array([1, 1, 0]), 2)
    out = tfhe.gates.nand(sk, a, b)
    bits = tfhe.decrypt(ck, out)        # [0, 1, 1]
"""

from tfhe_tpu_torch.models import boolean as gates
from tfhe_tpu_torch.models.boolean import bootstrap_identity, decrypt, encrypt
from tfhe_tpu_torch.models.keys import (
    ClientKey,
    ServerKey,
    keygen,
    keys_from_numpy,
    make_server_key,
)
from tfhe_tpu_torch.params import (
    DecomposerParams,
    GgswParams,
    GlweParams,
    LweParams,
    PARAMS,
    TfheParams,
    get_params,
)

__all__ = [
    "ClientKey",
    "DecomposerParams",
    "GgswParams",
    "GlweParams",
    "LweParams",
    "PARAMS",
    "ServerKey",
    "TfheParams",
    "bootstrap_identity",
    "decrypt",
    "encrypt",
    "gates",
    "get_params",
    "keygen",
    "keys_from_numpy",
    "make_server_key",
]
