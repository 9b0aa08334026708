"""Client/server keys and key generation (port of ``tfhe_tpu/models/keys.py``).

Keys are dataclasses of int32 tensors carrying u32 (see ``ops/torus.py``), all
on one device:

  * ``ServerKey.bk_u32`` — canonical GGSW tensor u32[n, R, k+1, N] (Kernel B
    and the plain scan read it);
  * ``ServerKey.bk_lm``  — the same rows level-major (r' = level*(k+1)+poly),
    for the per-step external-product kernel (impl='pallas');
  * ``ServerKey.ksk_mat`` — KSK as int8 limbs [kN*l_ks, (n+1)*4].

Key generation is split into a deterministic core with explicit mask/noise
tensors (bit-comparable with the JAX package) and a sampling wrapper.
``keys_from_numpy`` takes the JAX package's canonical arrays (the ``.npz``
fields of ``tfhe_tpu/utils/serialization.py``) so both packages compute with
the same key.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from tfhe_tpu_torch.models import ggsw as mggsw
from tfhe_tpu_torch.models import glwe as mglwe
from tfhe_tpu_torch.models import keyswitch as mks
from tfhe_tpu_torch.ops import sampling
from tfhe_tpu_torch.ops.poly import level_major_row_perm
from tfhe_tpu_torch.ops.torus import u32
from tfhe_tpu_torch.params import TfheParams


@dataclass(frozen=True)
class ClientKey:
    """Secret keys (src/lwe.rs:50-60, src/glwe.rs:172-182)."""

    lwe_sk: torch.Tensor  # u32[n] binary
    glwe_sk: torch.Tensor  # u32[k, N] binary
    params: TfheParams

    @property
    def device(self) -> torch.device:
        return self.lwe_sk.device

    def to(self, device) -> "ClientKey":
        return dataclasses.replace(
            self, lwe_sk=self.lwe_sk.to(device), glwe_sk=self.glwe_sk.to(device))


@dataclass(frozen=True)
class ServerKey:
    """Bootstrapping key + key-switching key (src/bootstrapping.rs:18-21)."""

    bk_u32: torch.Tensor  # u32[n, R, k+1, N] (canonical GGSW row order)
    bk_lm: torch.Tensor  # u32[n, R, k+1, N], rows level-major
    ksk_u32: torch.Tensor  # u32[kN*l_ks, n+1]
    ksk_mat: torch.Tensor  # int8[kN*l_ks, (n+1)*4]
    params: TfheParams

    @property
    def device(self) -> torch.device:
        return self.bk_u32.device

    def to(self, device) -> "ServerKey":
        return dataclasses.replace(
            self, bk_u32=self.bk_u32.to(device), bk_lm=self.bk_lm.to(device),
            ksk_u32=self.ksk_u32.to(device), ksk_mat=self.ksk_mat.to(device))


def _server_key_from_canonical(params: TfheParams, bk_u32, ksk_u32) -> ServerKey:
    """Derive the contraction layouts from the canonical tensors."""
    perm = level_major_row_perm(params.glwe_dimension + 1, params.pbs_decomposer.levels)
    bk_lm = bk_u32[:, torch.as_tensor(perm, device=bk_u32.device)].contiguous()
    return ServerKey(bk_u32=bk_u32.contiguous(), bk_lm=bk_lm, ksk_u32=ksk_u32,
                     ksk_mat=mks.ksk_to_matmul(ksk_u32), params=params)


def make_server_key(params: TfheParams, lwe_sk, glwe_sk, bk_a, bk_e, ksk_a,
                    ksk_e) -> ServerKey:
    """Deterministic keygen core (src/bootstrapping.rs:23-56), on the device of
    ``bk_a``.

    bk_a: u32[n, R, k, N]; bk_e: u32[n, R, N];
    ksk_a: u32[kN*l_ks, n]; ksk_e: u32[kN*l_ks].
    """
    bk_a = u32(bk_a)
    device = bk_a.device
    lwe_sk = u32(lwe_sk, device)
    glwe_sk = u32(glwe_sk, device)
    sk_t = mglwe.sk_toeplitz(glwe_sk)
    bk_u32 = mggsw.encrypt(sk_t, lwe_sk, params, bk_a, u32(bk_e, device))
    ksk_u32 = mks.generate_ksk(glwe_sk.reshape(-1), lwe_sk, params.ks_decomposer,
                               u32(ksk_a, device), u32(ksk_e, device))
    return _server_key_from_canonical(params, bk_u32, ksk_u32)


def keys_from_numpy(params: TfheParams, lwe_sk, glwe_sk, bk_u32, ksk_u32,
                    device=None) -> tuple[ClientKey, ServerKey]:
    """Build the port's keys from canonical u32 arrays (the JAX package's
    ``ClientKey``/``ServerKey`` fields, or its ``.npz`` wire format)."""
    ck = ClientKey(lwe_sk=u32(lwe_sk, device), glwe_sk=u32(glwe_sk, device),
                   params=params)
    sk = _server_key_from_canonical(params, u32(bk_u32, device), u32(ksk_u32, device))
    return ck, sk


def keygen(params: TfheParams, generator: torch.Generator | int = 0,
           device=None) -> tuple[ClientKey, ServerKey]:
    """Sample secret keys and derive the server key (src/utils.rs:238-243 +
    src/bootstrapping.rs:23-56).  Randomness comes from ``generator`` (or a
    CPU generator seeded with the given int); the keys land on ``device``
    (default: the generator's device)."""
    if isinstance(generator, int):
        generator = torch.Generator().manual_seed(generator)
    device = generator.device if device is None else torch.device(device)
    k, n, N = params.glwe_dimension, params.lwe_dimension, params.degree
    dp, ks = params.pbs_decomposer, params.ks_decomposer
    rows = (k + 1) * dp.levels
    kn = k * N
    lwe_sk = sampling.binary(generator, (n,)).to(device)
    glwe_sk = sampling.binary(generator, (k, N)).to(device)
    bk_a = sampling.uniform_u32(generator, (n, rows, k, N)).to(device)
    bk_e = sampling.gaussian_torus(generator, params.glwe_std_dev, (n, rows, N)).to(device)
    ksk_a = sampling.uniform_u32(generator, (kn * ks.levels, n)).to(device)
    ksk_e = sampling.gaussian_torus(generator, params.lwe_std_dev, (kn * ks.levels,)).to(device)
    ck = ClientKey(lwe_sk=lwe_sk, glwe_sk=glwe_sk, params=params)
    sk = make_server_key(params, lwe_sk, glwe_sk, bk_a, bk_e, ksk_a, ksk_e)
    return ck, sk
