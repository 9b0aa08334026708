"""LWE key switching (port of ``tfhe_tpu/models/keyswitch.py``; reference:
src/key_switching.rs) — one exact matmul.

The reference's per-digit scaled_add loop (src/key_switching.rs:81-89) is a
single [B, from_n*levels] x [from_n*levels, (to_n+1)*4] small-integer matmul
over the KSK's signed limb split, recombined with wrapping shifts.
"""

from __future__ import annotations

import torch

from tfhe_tpu_torch.models import lwe as mlwe
from tfhe_tpu_torch.ops.decomposer import decompose_signed
from tfhe_tpu_torch.ops.torus import (
    NUM_LIMBS,
    combine_limb_accs,
    int_matmul,
    to_signed_limbs,
    u32,
)
from tfhe_tpu_torch.params import DecomposerParams


def generate_ksk(from_sk, to_sk, ks: DecomposerParams, a, e) -> torch.Tensor:
    """KSK u32[from_n*levels, to_n+1]; row s*levels+j = LWE_to(s_bit*B^(l_full-j-1))
    (src/key_switching.rs:20-60).  a: u32[from_n*levels, to_n], e: u32[from_n*levels]."""
    a = u32(a)
    from_sk = u32(from_sk, a.device)
    shifts = [ks.log_base * (ks.l_full - 1 - j) for j in range(ks.levels)]
    factors = torch.stack([from_sk << s for s in shifts], dim=-1).reshape(-1)
    return mlwe.encrypt(to_sk, factors, a, e)


def ksk_to_matmul(ksk_u32) -> torch.Tensor:
    """u32[K, to_n+1] -> int8[K, (to_n+1)*4] signed limb layout for the matmul."""
    ksk = u32(ksk_u32)
    return to_signed_limbs(ksk).reshape(ksk.shape[0], -1)


def key_switch(ct, from_n: int, ks: DecomposerParams, ksk_mat_i8) -> torch.Tensor:
    """out = (0,..,0,b) - sum a_ij * KSK_row (src/key_switching.rs:63-103).

    ct: u32[..., from_n+1]; ksk_mat_i8 from ``ksk_to_matmul``.  Digits are
    MSB-first (src/decomposer.rs:72), matching the KSK row order.
    """
    ct = u32(ct)
    lead = ct.shape[:-1]
    digits = decompose_signed(ct[..., :from_n], ks)  # [..., from_n, levels]
    acc = int_matmul(digits.reshape(lead + (from_n * ks.levels,)), ksk_mat_i8)
    to_n1 = ksk_mat_i8.shape[1] // NUM_LIMBS
    out = -combine_limb_accs(acc.reshape(lead + (to_n1, NUM_LIMBS)))
    out[..., -1] += ct[..., from_n]
    return out
