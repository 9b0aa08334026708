"""Negacyclic polynomial ops in Z_{2^32}[X]/(X^N+1) (port of ``tfhe_tpu/ops/poly.py``).

The plain formulation of every TFHE product: one side is small (gadget
digits, binary secret bits), the u32 side splits into 4 balanced signed 8-bit
limbs (``ops/torus.py``), and the contraction against the sign-twisted
Toeplitz expansion of the u32 side is an exact small-integer matmul
(``torus.int_matmul``), recombined with wrapping shifts.  These functions are
the plain twins the CUDA kernels under ``ops/cuda/`` are held against.

u32 values are int32 tensors (see ``ops/torus.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from tfhe_tpu_torch.ops.torus import (
    combine_limb_accs,
    int_matmul,
    to_signed_limbs,
    u32,
)

NUM_LIMBS = 4


def monomial_mul(poly, exp) -> torch.Tensor:
    """poly(X) * X^exp with negacyclic wraparound (src/utils.rs:183-207).

    ``poly``: u32[..., N]; ``exp``: integer(s) broadcastable to
    ``poly.shape[:-1]`` (may be negative; reduced mod 2N).  A gather with the
    closed-form sign: out[i] = (-1)^floor(((i-e) mod 2N)/N) * poly[(i-e) mod N].
    """
    poly = u32(poly)
    n = poly.shape[-1]
    e = torch.as_tensor(exp, device=poly.device).to(torch.int64)
    e = torch.broadcast_to(e, poly.shape[:-1]).unsqueeze(-1)
    src = torch.arange(n, device=poly.device) - torch.remainder(e, 2 * n)
    idx = torch.remainder(src, n).expand(poly.shape)
    out = torch.gather(poly, -1, idx)
    return torch.where(torch.remainder(src, 2 * n) >= n, -out, out)


def _toeplitz_index(n: int, device):
    m = torch.arange(n, device=device)[:, None]
    o = torch.arange(n, device=device)[None, :]
    return torch.remainder(o - m, n), m <= o


def sign_toeplitz_u32(p_u32) -> torch.Tensor:
    """u32 poly [..., N] -> u32[..., N(m), N(o)] with T[m,o] = +-p[(o-m)%N].

    Negation happens in u32 (wrapping, exact) BEFORE any limb split: the
    balanced int8 limb -128 cannot be negated in int8.
    """
    p = u32(p_u32)
    idx, keep = _toeplitz_index(p.shape[-1], p.device)
    t = p[..., idx]
    return torch.where(keep, t, -t)


def sign_toeplitz_small(p_small) -> torch.Tensor:
    """Small-int poly [..., N] -> int8[..., N(m), N(o)] with T[m,o] = +-p[(o-m)%N]
    (contraction-major: ``a[..., m] @ T[m, o]`` is the negacyclic product)."""
    p = torch.as_tensor(p_small).to(torch.int8)
    idx, keep = _toeplitz_index(p.shape[-1], p.device)
    t = p[..., idx]
    return torch.where(keep, t, -t)


def negacyclic_matvec_u32_small(a_u32, t_small) -> torch.Tensor:
    """Exact wrapping contraction a[..., K] x T[K, N] -> u32[..., N] (``a`` full
    u32, limb-split; ``T`` small signed, e.g. stacked sign-Toeplitz blocks of
    binary secret polynomials; src/utils.rs:163-173)."""
    limbs = to_signed_limbs(a_u32).movedim(-1, -2)  # [..., 4, K]
    acc = int_matmul(limbs, t_small)  # [..., 4, N]
    return combine_limb_accs(acc.movedim(-2, -1))


def bk_to_matmul_w(bk_u32, key_limbs: int = NUM_LIMBS) -> torch.Tensor:
    """GGSW u32[R, C, N] -> Toeplitz weights int8[R*N(m), C*4*N(o)].

    W[(r,m),(c,l,o)] = limb_l( +-g[r,c,(o-m)%N] ), sign applied in u32
    before the limb split.  Column layout (c, limb, o) matches ``ep_combine``.
    ``key_limbs=3`` zeroes limb 0 (the truncated-key mode of the whole-scan
    kernels: the low byte of each sign-twisted word is dropped).
    """
    if key_limbs not in (3, NUM_LIMBS):
        raise ValueError(f"key_limbs is 4 (exact) or 3 (truncated), got {key_limbs}")
    t = sign_toeplitz_u32(bk_u32)  # [R, C, m, o]
    limbs = to_signed_limbs(t)  # [R, C, m, o, L]
    if key_limbs == 3:
        limbs[..., 0] = 0
    limbs = limbs.movedim(-1, -2).transpose(1, 2)  # [R, m, C, L, o]
    r, c, n = bk_u32.shape
    return limbs.reshape(r * n, c * NUM_LIMBS * n)


def ep_contract_matmul(digits_i8, bk_u32, key_limbs: int = NUM_LIMBS) -> torch.Tensor:
    """Exact external-product contraction: digits int8[B, R, N] x GGSW
    u32[R, C, N] -> int32[B, C*4, N] limb accumulators,
    out[b,(c,l),o] = sum_{r,m} digits[b,r,m] * limb_l(+-g[r,c,(o-m)%N])
    (limb 0 taken as 0 when ``key_limbs=3``).

    The Toeplitz expansion is built per call and shared across the batch;
    the product runs one column block at a time to bound the float64 copy.
    """
    b = digits_i8.shape[0]
    r, n = digits_i8.shape[-2:]
    c = bk_u32.shape[1]
    w = bk_to_matmul_w(bk_u32, key_limbs).view(r * n, c, NUM_LIMBS * n)
    flat = digits_i8.reshape(b, r * n)
    acc = torch.stack([int_matmul(flat, w[:, j]) for j in range(c)], dim=1)
    return acc.reshape(b, c * NUM_LIMBS, n)


def ep_combine(acc_i32, k_plus_1: int) -> torch.Tensor:
    """int32[B, C*4, N] limb accumulators -> u32[B, C, N] wrapping GLWE delta."""
    b, _, n = acc_i32.shape
    accs = acc_i32.reshape(b, k_plus_1, NUM_LIMBS, n).movedim(-2, -1)
    return combine_limb_accs(accs)


def ep_combine_planes(acc_i32) -> torch.Tensor:
    """int32[C, L, B, N] limb planes -> u32[C, B, N] wrapping delta."""
    return combine_limb_accs(acc_i32.movedim(1, -1))


def level_major_row_perm(k_plus_1: int, levels: int) -> np.ndarray:
    """Permutation mapping level-major row r' = level*(k+1)+poly to the
    canonical GGSW row poly*levels+level (src/ggsw.rs:43-75 layout)."""
    rp = np.arange(k_plus_1 * levels)
    return (rp % k_plus_1) * levels + (rp // k_plus_1)
