"""tfhe_tpu_torch — the TFHE framework on PyTorch and CUDA (port of ``tfhe_tpu``).

The same scheme, layouts and bit-exact u32 arithmetic as the JAX package,
written as plain functions on torch tensors (u32 carried as wrapping int32,
``ops/torus.py``), with hand-written Hopper kernels for the blind rotation
(``csrc/``, built at first use into ``build/tfhe_tpu_torch/``).  It imports
neither JAX nor ``tfhe_tpu``.

Entry points run on the card: ``keygen`` and ``keys_from_numpy`` put the
keys on ``"cuda"`` unless the caller passes another ``device`` (the tests
pass ``device="cpu"``, where every kernel wrapper runs its plain twin).

Quick start::

    import numpy as np, tfhe_tpu_torch as tfhe
    params = tfhe.get_params("default_128")
    ck, sk = tfhe.keygen(params, 0)
    a = tfhe.encrypt(ck, np.array([1, 0, 1]), 1)
    b = tfhe.encrypt(ck, np.array([1, 1, 0]), 2)
    out = tfhe.gates.nand(sk, a, b)
    bits = tfhe.decrypt(ck, out)        # [0, 1, 1]

Small batches (B <= 8) take the latency kernel::

    ck, sk = tfhe.keygen(params, 0, bmmp=True)
    sk = tfhe.with_latency_key(sk)
    out = tfhe.gates.nand(sk, a, b, impl="fusedl")      # or "bmmpl" (B <= 4)
    s = tfhe.circuits.add_uint(sk, tfhe.circuits.encrypt_uint(ck, [200], 8, 3),
                               tfhe.circuits.encrypt_uint(ck, [100], 8, 4), impl="fusedl")
    tfhe.circuits.decrypt_uint(ck, s)   # [44]

The block-NTT tier: 'nttf' runs the whole rotation in Kernel D on the lhs-form
NTT key, 'ntt' and 'ntts' are its plain per-step scans (resident and streamed
key); all three equal 'fused' bit for bit::

    sk = tfhe.with_ntt_lhs_key(tfhe.with_ntt_key(sk))   # 1.9 GB each at default_128
    out = tfhe.gates.nand(sk, a, b, impl="nttf")        # or "ntt", "ntts"

Entry points: the client/server CLI ``python -m tfhe_tpu_torch.cli`` on the
JAX package's ``.npz`` key and ciphertext files (``utils/serialization.py``;
a server loads ``server.npz``, which holds no secret key, through
``server_key_from_numpy`` and attaches its impl's key form with
``with_key_form``), and the benches ``python -m tfhe_tpu_torch.bench`` (one
JSON line in ``bench.py``'s format) and ``python -m tfhe_tpu_torch.bench_adder``.

Multi-card: ``tfhe_tpu_torch.parallel`` (device meshes, the batch-, row-,
coefficient- and NTT-bin-sharded gates and the pipelined gate on
``torch.distributed``, one process per rank) and its bench ``python -m
tfhe_tpu_torch.bench_scaling``.
"""

from tfhe_tpu_torch.models import boolean as gates
from tfhe_tpu_torch.models import circuits
from tfhe_tpu_torch.models.boolean import bootstrap_identity, decrypt, encrypt
from tfhe_tpu_torch.models.keys import (
    ClientKey,
    ServerKey,
    keygen,
    keys_from_numpy,
    make_server_key,
    server_key_from_numpy,
    with_key_form,
    with_latency_key,
    with_ntt_key,
    with_ntt_lhs_key,
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
    "circuits",
    "decrypt",
    "encrypt",
    "gates",
    "get_params",
    "keygen",
    "keys_from_numpy",
    "make_server_key",
    "server_key_from_numpy",
    "with_key_form",
    "with_latency_key",
    "with_ntt_key",
    "with_ntt_lhs_key",
]
