"""LWE over Z_{2^32} (port of ``tfhe_tpu/models/lwe.py``; reference: src/lwe.rs).

Ciphertext: u32[..., n+1] = (a_0..a_{n-1}, b), carried as int32 (see
``ops/torus.py``).  Every function takes a leading batch of any shape.
"""

from __future__ import annotations

import torch

from tfhe_tpu_torch.ops.torus import u32, wrapping_matvec_u32_small


def _sk_col(sk) -> torch.Tensor:
    """Binary secret u32[n] -> int8[n, 1] for the exact limb matvec."""
    return u32(sk).to(torch.int8)[:, None]


def encrypt(sk, pt, a, e) -> torch.Tensor:
    """(a, <a,s> + e + pt), wrapping (src/lwe.rs:138-160); fully batched."""
    a = u32(a)
    sk = u32(sk, a.device)
    b = wrapping_matvec_u32_small(a, _sk_col(sk))[..., 0] + u32(e, a.device) + u32(pt, a.device)
    return torch.cat([a, b[..., None]], dim=-1)


def decrypt(sk, ct) -> torch.Tensor:
    """b - <a,s> (src/lwe.rs:162-173)."""
    ct = u32(ct)
    a_s = wrapping_matvec_u32_small(ct[..., :-1], _sk_col(u32(sk, ct.device)))[..., 0]
    return ct[..., -1] - a_s


def add(c0, c1) -> torch.Tensor:
    """ct + ct (src/lwe.rs:9-15); uniformly wrapping."""
    return u32(c0) + u32(c1)


def scalar_mul(ct, scalar: int) -> torch.Tensor:
    """ct * k (src/lwe.rs:17-23)."""
    return u32(ct) * scalar
