"""Vectorized signed gadget decomposition (port of ``tfhe_tpu/ops/decomposer.py``).

The default digits follow the reference's exact carry chain
(src/decomposer.rs:42-80), run over all ``log_q/log_base`` positions, with its
anomalous digit +B where digit B-1 meets an incoming carry: digits lie in
{-B/2 .. B/2-1} union {B}.  ``decompose_balanced_planes`` is the closed form
(impl='fusedb'): the same rounding and the same exact mod-2^32
reconstruction, digits in [-B/2, B/2), no carry (DIVERGENCES.md #3).

u32 values are int32 tensors (see ``ops/torus.py``).
"""

from __future__ import annotations

import torch

from tfhe_tpu_torch.ops.torus import i32, shr, u32
from tfhe_tpu_torch.params import DecomposerParams


def round_value(value, p: DecomposerParams) -> torch.Tensor:
    """Round off ignored LSBs to nearest, half up (src/decomposer.rs:27-40)."""
    value = u32(value)
    ig = p.ignored_bits
    if ig == 0:
        return value
    ignored_msb = shr(value & ((1 << ig) - 1), ig - 1)
    return (shr(value, ig) + ignored_msb) << ig


def _carry_chain(value, p: DecomposerParams) -> list[torch.Tensor]:
    """The full carry chain over l_full positions -> kept digits as wrapping
    u32, MSB-first."""
    value = round_value(value, p)
    log_base = p.log_base
    base_mask = (1 << log_base) - 1
    half_mask = 1 << (log_base - 1)
    carry = torch.zeros_like(value)
    digits = []
    for l in range(p.l_full):
        res = (shr(value, log_base * l) & base_mask) + carry
        carry_mask = res & half_mask
        res = res - (carry_mask << 1)
        carry = shr(carry_mask, log_base - 1)
        digits.append(res)
    digits.reverse()
    return digits[: p.levels]


def decompose_u32(value, p: DecomposerParams) -> torch.Tensor:
    """Exact carry-chain decomposition; u32[...] -> u32[..., levels], MSB-first
    (src/decomposer.rs:42-80)."""
    return torch.stack(_carry_chain(value, p), dim=-1)


def digits_to_signed(digits_u32, p: DecomposerParams) -> torch.Tensor:
    """Wrapping-u32 digits -> int8 in [-B/2, B] via (log_base+2)-bit sign-extend."""
    bits = p.log_base + 2
    d = u32(digits_u32)
    v = (d & ((1 << bits) - 1)) - 2 * (d & (1 << (bits - 1)))
    return v.to(torch.int8)


def decompose_signed(value, p: DecomposerParams) -> torch.Tensor:
    """u32[...] -> int8[..., levels] signed digits, MSB-first."""
    return digits_to_signed(decompose_u32(value, p), p)


def decompose_signed_planes(value, p: DecomposerParams) -> torch.Tensor:
    """Like ``decompose_signed`` with the level axis FIRST:
    u32[...] -> int8[levels, ...] (MSB-first)."""
    return torch.stack([digits_to_signed(d, p) for d in _carry_chain(value, p)])


def recompose(digits_u32, p: DecomposerParams) -> torch.Tensor:
    """sum(d_i * B^(levels-1-i)) << ignored_bits (src/decomposer.rs:83-95)."""
    d = u32(digits_u32)
    value = torch.zeros(d.shape[:-1], dtype=torch.int32, device=d.device)
    for i in range(p.levels):
        value = value + (d[..., i] << (p.log_base * (p.levels - 1 - i)))
    return value << p.ignored_bits


def balanced_offset(p: DecomposerParams) -> int:
    """The pre-shift constant C of the closed-form balanced decomposition:
    C = (H << ig) + 2^(ig-1) with H = sum_l (B/2) B^l over the kept levels.
    ``(v + C) >> ig`` performs the reference's half-up rounding AND the
    balanced re-centering offset in one wrapping add."""
    half = 1 << (p.log_base - 1)
    hh = sum(half << (p.log_base * l) for l in range(p.levels))
    ig = p.ignored_bits
    if ig == 0:
        return hh
    return ((hh << ig) + (1 << (ig - 1))) & 0xFFFFFFFF


def decompose_balanced_planes(value, p: DecomposerParams) -> torch.Tensor:
    """Closed-form balanced decomposition: u32[...] -> int8[levels, ...],
    MSB-first, digits in [-B/2, B/2).

    Exact: sum_l d_l B^(levels-1-l) << ignored_bits == round_value(value)
    (mod 2^32), the same reconstruction and rounding as the carry chain.
    """
    b = p.log_base
    half = 1 << (b - 1)
    u = shr(u32(value) + i32(balanced_offset(p)), p.ignored_bits)
    mask = (1 << b) - 1
    planes = [((shr(u, b * l) & mask) - half).to(torch.int8) for l in range(p.levels)]
    planes.reverse()
    return torch.stack(planes)
