"""Key/ciphertext serialization (port of ``tfhe_tpu/utils/serialization.py``):
the client/server separation.  A client keeps its secret keys, hands the
server key to a server, and exchanges ciphertext files with it.

Format, the JAX package's, so files interchange both ways: a single ``.npz``
(``np.savez_compressed``) with u32 arrays plus the parameter set as a JSON
string.
  * client file: ``lwe_sk``, ``glwe_sk``, ``params``;
  * server file: ``bk_u32``, ``ksk_u32``, ``params`` and, for a BMMP key,
    ``bk_bmmp_lm``;
  * ciphertext file: ``data``, ``params``.
Every u32 array is written as ``np.uint32`` (``ops/torus.py:to_numpy_u32``),
never as the ``int32`` the port carries, and a loader refuses an array of
another dtype: read by value, it would compute on other bits.  Derived key
forms (``bk_lm``, ``ksk_mat``) are rebuilt on load; the optional ones
(``bk_lat``, ``bk_ntt``, ``bk_ntt_lhs``) are not stored, as in the JAX
package: attach them to a loaded key (``models/keys.py:with_key_form``).
Loaders put what they read on ``device``, the card unless the caller asks
for another.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from tfhe_tpu_torch.models.keys import ClientKey, ServerKey, server_key_from_numpy
from tfhe_tpu_torch.ops.torus import to_numpy_u32, to_torch_u32
from tfhe_tpu_torch.params import DecomposerParams, TfheParams


def params_to_json(p: TfheParams) -> str:
    return json.dumps(dataclasses.asdict(p))


def params_from_json(s: str) -> TfheParams:
    d = json.loads(s)
    d["ks_decomposer"] = DecomposerParams(**d["ks_decomposer"])
    d["pbs_decomposer"] = DecomposerParams(**d["pbs_decomposer"])
    return TfheParams(**d)


def _u32_field(z, name: str, path) -> np.ndarray:
    arr = z[name]
    if arr.dtype != np.uint32:
        raise ValueError(f"{path}: {name!r} is {arr.dtype}, expected uint32")
    return arr


def save_client_key(path, ck: ClientKey) -> None:
    np.savez_compressed(
        path,
        lwe_sk=to_numpy_u32(ck.lwe_sk),
        glwe_sk=to_numpy_u32(ck.glwe_sk),
        params=np.array(params_to_json(ck.params)),
    )


def load_client_key(path, device="cuda") -> ClientKey:
    with np.load(path) as z:
        return ClientKey(
            lwe_sk=to_torch_u32(_u32_field(z, "lwe_sk", path), device),
            glwe_sk=to_torch_u32(_u32_field(z, "glwe_sk", path), device),
            params=params_from_json(str(z["params"])),
        )


def save_server_key(path, sk: ServerKey) -> None:
    """Canonical u32 tensors only; derived layouts rebuilt on load.  The
    optional BMMP key triples ride along when present."""
    arrays = dict(
        bk_u32=to_numpy_u32(sk.bk_u32),
        ksk_u32=to_numpy_u32(sk.ksk_u32),
        params=np.array(params_to_json(sk.params)),
    )
    if sk.bk_bmmp_lm is not None:
        arrays["bk_bmmp_lm"] = to_numpy_u32(sk.bk_bmmp_lm)
    np.savez_compressed(path, **arrays)


def load_server_key(path, device="cuda") -> ServerKey:
    """Rebuilds ``bk_lm`` and ``ksk_mat`` from the canonical tensors
    (``models/keys.py:server_key_from_numpy``)."""
    with np.load(path) as z:
        bmmp = _u32_field(z, "bk_bmmp_lm", path) if "bk_bmmp_lm" in z else None
        return server_key_from_numpy(
            params_from_json(str(z["params"])), _u32_field(z, "bk_u32", path),
            _u32_field(z, "ksk_u32", path), device=device, bk_bmmp_lm=bmmp)


def save_ciphertexts(path, cts: torch.Tensor, params: TfheParams) -> None:
    np.savez_compressed(
        path, data=to_numpy_u32(cts), params=np.array(params_to_json(params)))


def load_ciphertexts(path, device="cuda") -> tuple[torch.Tensor, TfheParams]:
    with np.load(path) as z:
        data = to_torch_u32(_u32_field(z, "data", path), device)
        return data, params_from_json(str(z["params"]))
