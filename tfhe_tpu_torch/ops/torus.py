"""Torus Z_{2^32} primitives on torch tensors (port of ``tfhe_tpu/ops/torus.py``).

torch's ``uint32`` has no ``+``, ``>>`` or unary minus on the CPU, so the port
carries every u32 torus value as a wrapping ``int32`` tensor: addition,
subtraction, negation, multiplication and left shifts are the same bits mod
2^32.  Two things differ and are handled here:

  * ``>>`` on int32 is arithmetic, so ``shr`` masks after it (a logical shift);
  * comparisons and widening see the signed value, so code that needs the
    unsigned magnitude goes through ``to_numpy_u32`` or masks an int64 copy.

``to_torch_u32`` / ``to_numpy_u32`` move u32 arrays across the boundary by a
``view``, never by a value conversion.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
#: number of 8-bit limbs in a u32
NUM_LIMBS = 4
#: adds +128 at every limb position; balanced-limb split offset
_LIMB_BIAS = 0x80808080


def i32(value: int) -> int:
    """A u32 constant as the int32 that carries the same bits."""
    value &= MASK32
    return value - (1 << 32) if value >= 1 << 31 else value


def to_torch_u32(x, device=None) -> torch.Tensor:
    """u32 data (numpy array, scalar or sequence) -> int32 tensor, same bits."""
    arr = np.ascontiguousarray(np.asarray(x).astype(np.uint32))
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def to_numpy_u32(t: torch.Tensor) -> np.ndarray:
    """int32 tensor carrying u32 -> numpy uint32 array, same bits."""
    if t.dtype != torch.int32:
        raise TypeError(f"expected an int32 tensor carrying u32, got {t.dtype}")
    return t.detach().cpu().numpy().view(np.uint32)


def u32(x, device=None) -> torch.Tensor:
    """Anything u32-valued -> an int32 tensor carrying it.  A tensor of
    another integer dtype is narrowed with wraparound (mod 2^32)."""
    if isinstance(x, torch.Tensor):
        t = x if x.dtype == torch.int32 else x.to(torch.int64).to(torch.int32)
        return t if device is None else t.to(device)
    return to_torch_u32(x, device)


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of an int32-carried u32 by a constant ``s``."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (32 - s)) - 1)


def encode(m, log_q: int, log_p: int, padding_bits: int) -> torch.Tensor:
    """Cleartext -> plaintext: m << (log_q - log_p - padding) (src/lwe.rs:83-88)."""
    shift = log_q - (log_p + padding_bits)
    return u32(m) << shift


def decode(pt, log_q: int, log_p: int, padding_bits: int) -> torch.Tensor:
    """Rounding decode: round(pt/Delta) mod 2^(log_p+padding), then mod 2^log_p
    (negative blind-rotation indices alias the padding bit,
    src/test_vector.rs:54-64)."""
    shift = log_q - (log_p + padding_bits)
    half = 1 << (shift - 1)
    return shr(u32(pt) + half, shift) & ((1 << log_p) - 1)


def switch_modulus(values, log_from: int, log_to: int) -> torch.Tensor:
    """round(2^log_to * v / 2^log_from) mod 2^log_to, overflow-free round-half-up
    (src/utils.rs:13-33)."""
    v = u32(values)
    shift = log_from - log_to
    d_half = 1 << (shift - 1)
    low_mask = (1 << shift) - 1
    rounded = shr(v, shift) + shr((v & low_mask) + d_half, shift)
    return rounded & ((1 << log_to) - 1)


def to_signed_limbs(x) -> torch.Tensor:
    """u32[...] -> int8[..., 4] balanced limbs: x == sum(limb_i * 2^(8i)) mod 2^32."""
    t = u32(x) + i32(_LIMB_BIAS)
    limbs = [(shr(t, 8 * i) & 0xFF) - 128 for i in range(NUM_LIMBS)]
    return torch.stack(limbs, dim=-1).to(torch.int8)


def combine_limb_accs(accs_i32: torch.Tensor) -> torch.Tensor:
    """int32[..., 4] limb accumulators -> u32[...], wrapping: sum(acc_i << 8i)."""
    out = accs_i32[..., 0]
    for i in range(1, NUM_LIMBS):
        out = out + (accs_i32[..., i] << (8 * i))
    return out


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact small-integer product a[..., K] @ b[K, M] -> int32[..., M].

    The operands hold int8-range values.  The product runs in float64, which
    is exact while every partial sum stays below 2^53; ``params.validate``
    bounds every contraction of the framework below 2^31.  (torch's CUDA
    matmul refuses int8 and int64, and ``torch._int_mm`` needs more than 16
    rows and widths that are multiples of 8.)
    """
    out = torch.matmul(a.to(torch.float64), b.to(torch.float64))
    return out.to(torch.int64).to(torch.int32)


def wrapping_matvec_u32_small(a_u32, w_small: torch.Tensor) -> torch.Tensor:
    """Exact wrapping u32 contraction  a[..., K] @ w[K, M] -> u32[..., M].

    ``a`` is full u32 (split into signed limbs); ``w`` holds small signed
    integers (secret bits / Toeplitz-of-binary entries, |w| <= 127).
    """
    limbs = to_signed_limbs(a_u32).movedim(-1, -2)  # [..., 4, K]
    acc = int_matmul(limbs, w_small)  # [..., 4, M]
    return combine_limb_accs(acc.movedim(-2, -1))
