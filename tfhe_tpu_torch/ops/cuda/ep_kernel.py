"""Kernel A: the per-step external-product contraction (counterpart of
``tfhe_tpu/ops/pallas/ep_kernel.py:ep_contract_pallas_rbn``).

``ep_contract_rbn`` launches ``csrc/ep_kernel.cu`` for CUDA tensors and runs
its plain twin ``ep_contract_rbn_ref`` for CPU tensors; it raises for
anything else.  u32 key words are int32 tensors (see ``ops/torus.py``).
"""

from __future__ import annotations

import ctypes

import torch

from tfhe_tpu_torch.ops.cuda._build import CudaKernel, check_cuda_operand, ptr, stream_of
from tfhe_tpu_torch.ops.poly import NUM_LIMBS, ep_contract_matmul

KERNEL = CudaKernel(
    "ep_kernel", "ep_contract_rbn",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
)


def ep_contract_rbn_ref(digits_rbn_i8: torch.Tensor, bk_rows_u32: torch.Tensor) -> torch.Tensor:
    """Plain twin: digits int8[R, B, N] x GGSW rows u32[R, C, N] ->
    int32[C, 4, B, N] limb planes (``ep_contract_matmul`` in this layout)."""
    r, b, n = digits_rbn_i8.shape
    c = bk_rows_u32.shape[1]
    acc = ep_contract_matmul(digits_rbn_i8.transpose(0, 1), bk_rows_u32)  # [B, C*4, N]
    return acc.reshape(b, c, NUM_LIMBS, n).permute(1, 2, 0, 3).contiguous()


def ep_contract_rbn(digits_rbn_i8: torch.Tensor, bk_rows_u32: torch.Tensor) -> torch.Tensor:
    """digits int8[R, B, N] x GGSW rows u32[R, C, N] -> int32[C, 4, B, N]:
    out[c,l,b,o] = sum_{r,m} d[r,b,m] * limb_l(+-g[r,c,(o-m)%N]).

    Row order of ``digits`` and ``bk_rows`` must match (the blind rotation
    passes level-major rows with the correspondingly permuted key).
    """
    if digits_rbn_i8.device.type == "cpu" and bk_rows_u32.device.type == "cpu":
        return ep_contract_rbn_ref(digits_rbn_i8, bk_rows_u32)
    device = digits_rbn_i8.device
    if device.type != "cuda":
        raise ValueError(f"ep_contract_rbn runs on CPU or CUDA tensors, got {device}")
    r, b, n = digits_rbn_i8.shape
    c = bk_rows_u32.shape[1]
    check_cuda_operand("digits", digits_rbn_i8, torch.int8, (r, b, n), device)
    check_cuda_operand("bk_rows", bk_rows_u32, torch.int32, (r, c, n), device)
    out = torch.empty((c, NUM_LIMBS, b, n), dtype=torch.int32, device=device)
    KERNEL.launch(ptr(digits_rbn_i8), ptr(bk_rows_u32), ptr(out), r, b, c, n,
                  stream_of(out))
    return out
