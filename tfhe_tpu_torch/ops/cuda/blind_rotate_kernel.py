"""Kernel B: the whole-scan blind rotation (counterpart of
``tfhe_tpu/ops/pallas/blind_rotate_kernel.py:blind_rotate_fused`` with
``key_limbs=4``, both digit conventions).

``blind_rotate_fused`` launches ``csrc/blind_rotate_kernel.cu`` for CUDA
tensors and runs its plain twin ``blind_rotate_fused_ref`` for CPU tensors;
it raises for anything else.  u32 values are int32 tensors (see
``ops/torus.py``).
"""

from __future__ import annotations

import ctypes

import torch

from tfhe_tpu_torch.ops.cuda._build import CudaKernel, check_cuda_operand, ptr, stream_of
from tfhe_tpu_torch.ops.decomposer import (
    balanced_offset,
    decompose_balanced_planes,
    decompose_signed_planes,
)
from tfhe_tpu_torch.ops.poly import ep_combine, ep_contract_matmul, monomial_mul
from tfhe_tpu_torch.params import TfheParams

KERNEL = CudaKernel(
    "blind_rotate_kernel", "blind_rotate_fused",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_uint, ctypes.c_void_p],
)


def blind_rotate_fused_ref(params: TfheParams, acc0: torch.Tensor, bk_u32: torch.Tensor,
                           a_hat: torch.Tensor, balanced: bool = False) -> torch.Tensor:
    """Plain twin: per step, acc += EP(digits(acc * X^a - acc), BK_s) through
    ``monomial_mul`` -> decompose -> ``ep_contract_matmul`` -> ``ep_combine``.
    Digit rows are canonical (poly*levels + level)."""
    dp = params.pbs_decomposer
    b, k1, n = acc0.shape
    decompose = decompose_balanced_planes if balanced else decompose_signed_planes
    acc = acc0
    for s in range(bk_u32.shape[0]):
        rot = monomial_mul(acc, a_hat[s][:, None])
        digits = decompose(rot - acc, dp)  # [levels, B, k+1, N]
        digits = digits.permute(1, 2, 0, 3).reshape(b, k1 * dp.levels, n)
        acc = acc + ep_combine(ep_contract_matmul(digits, bk_u32[s]), k1)
    return acc


def blind_rotate_fused(params: TfheParams, acc0: torch.Tensor, bk_u32: torch.Tensor,
                       a_hat: torch.Tensor, balanced: bool = False) -> torch.Tensor:
    """acc0 u32[B, k+1, N], bk u32[n, R, k+1, N] (canonical rows), a_hat
    int32[n, B] -> the final accumulator u32[B, k+1, N].  ``balanced``
    selects the closed-form balanced digits (impl='fusedb') over the
    reference carry chain (impl='fused')."""
    if all(t.device.type == "cpu" for t in (acc0, bk_u32, a_hat)):
        return blind_rotate_fused_ref(params, acc0, bk_u32, a_hat, balanced)
    device = acc0.device
    if device.type != "cuda":
        raise ValueError(f"blind_rotate_fused runs on CPU or CUDA tensors, got {device}")
    b, k1, n = acc0.shape
    steps = bk_u32.shape[0]
    dp = params.pbs_decomposer
    check_cuda_operand("acc0", acc0, torch.int32, (b, k1, n), device)
    check_cuda_operand("bk_u32", bk_u32, torch.int32, (steps, k1 * dp.levels, k1, n), device)
    check_cuda_operand("a_hat", a_hat, torch.int32, (steps, b), device)
    out = torch.empty_like(acc0)
    KERNEL.launch(ptr(acc0), ptr(bk_u32), ptr(a_hat), ptr(out), steps, b, k1, n,
                  dp.levels, dp.log_base, dp.ignored_bits, int(balanced),
                  balanced_offset(dp), stream_of(out))
    return out
