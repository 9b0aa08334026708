"""GLWE (RLWE) over Z_{2^32}[X]/(X^N+1) (port of ``tfhe_tpu/models/glwe.py``;
reference: src/glwe.rs).

Ciphertext: u32[..., k+1, N], rows a_0..a_{k-1}, b, carried as int32.  The
secret key is used as a stacked sign-Toeplitz int8 matrix [k*N, N] that turns
every a.s polynomial dot product (src/utils.rs:163-173) into one exact matmul.
"""

from __future__ import annotations

import torch

from tfhe_tpu_torch.ops.decomposer import decompose_signed
from tfhe_tpu_torch.ops.poly import (
    monomial_mul,
    negacyclic_matvec_u32_small,
    sign_toeplitz_small,
)
from tfhe_tpu_torch.ops.torus import u32
from tfhe_tpu_torch.params import DecomposerParams


def sk_toeplitz(glwe_sk) -> torch.Tensor:
    """u32[k, N] binary key -> int8[k*N, N] stacked sign-Toeplitz blocks."""
    sk = u32(glwe_sk)
    k, n = sk.shape
    return sign_toeplitz_small(sk.to(torch.int8)).reshape(k * n, n)


def encrypt_zero(sk_t, a, e) -> torch.Tensor:
    """GLWE(0) = (a, sum a_i*s_i + e) (src/glwe.rs:190-209).

    a: u32[..., k, N]; e: u32[..., N]; sk_t from ``sk_toeplitz``.
    """
    a = u32(a)
    kn = a.shape[-2] * a.shape[-1]
    b = negacyclic_matvec_u32_small(a.reshape(a.shape[:-2] + (kn,)), sk_t) + u32(e, a.device)
    return torch.cat([a, b[..., None, :]], dim=-2)


def encrypt(sk_t, pt, a, e) -> torch.Tensor:
    """GLWE(pt): zero encryption + pt on the b row (src/glwe.rs:211-230)."""
    ct = encrypt_zero(sk_t, a, e)
    ct[..., -1, :] += u32(pt, ct.device)
    return ct


def trivial_encrypt(pt, glwe_dimension: int) -> torch.Tensor:
    """(0,...,0, pt) (src/glwe.rs:232-243); pt: u32[..., N]."""
    pt = u32(pt)
    zeros = torch.zeros(pt.shape[:-1] + (glwe_dimension, pt.shape[-1]),
                        dtype=torch.int32, device=pt.device)
    return torch.cat([zeros, pt[..., None, :]], dim=-2)


def decrypt(sk_t, ct) -> torch.Tensor:
    """b - sum a_i*s_i (src/glwe.rs:245-265)."""
    ct = u32(ct)
    a = ct[..., :-1, :]
    kn = a.shape[-2] * a.shape[-1]
    a_s = negacyclic_matvec_u32_small(a.reshape(a.shape[:-2] + (kn,)), sk_t)
    return ct[..., -1, :] - a_s


def mul_monomial(ct, exp) -> torch.Tensor:
    """Row-wise X^exp multiplication (src/glwe.rs:16-34); exp broadcastable to
    ct.shape[:-2] (per-sample exponents)."""
    ct = u32(ct)
    e = torch.as_tensor(exp, device=ct.device)
    return monomial_mul(ct, e[..., None])


def decompose(ct, dp: DecomposerParams) -> torch.Tensor:
    """(.., k+1, N) -> int8(.., (k+1)*levels, N), row = poly*levels + level
    (MSB-first), matching src/glwe.rs:69-108's layout."""
    digs = decompose_signed(ct, dp).movedim(-1, -2)  # [..., k+1, levels, N]
    return digs.reshape(digs.shape[:-3] + (digs.shape[-3] * digs.shape[-2], digs.shape[-1]))
