"""The external-product contraction kernels, both over ``csrc/ep_contract.cuh``:

  * Kernel A, ``ep_contract_rbn`` (``csrc/ep_kernel.cu``; counterpart of
    ``tfhe_tpu/ops/pallas/ep_kernel.py:ep_contract_pallas_rbn``): the
    per-step contraction of the ``pallas`` and ``bmmp`` scans, digits
    [R, B, N] -> limb planes [C, 4, B, N];
  * Kernel H, ``ep_contract`` (``csrc/ep_batch_kernel.cu``; counterpart of
    ``ep_contract_pallas``): the batch-major contraction of the ``conv``
    scan and of ``models/ggsw.external_product``, digits [B, R, N] -> limb
    sums [B, C*4, N].

Each wrapper launches its kernel for CUDA tensors and runs its plain twin
for CPU tensors; it raises for anything else.  u32 key words are int32
tensors (see ``ops/torus.py``).
"""

from __future__ import annotations

import ctypes

import torch

from tfhe_tpu_torch.ops.cuda._build import CudaKernel, check_cuda_operand, ptr, stream_of
from tfhe_tpu_torch.ops.poly import NUM_LIMBS, ep_contract_matmul

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
KERNEL = CudaKernel("ep_kernel", "ep_contract_rbn", _ARGTYPES)
BATCH_KERNEL = CudaKernel("ep_batch_kernel", "ep_contract", _ARGTYPES)


def _device_of(name: str, digits: torch.Tensor, bk: torch.Tensor) -> torch.device | None:
    """None when both operands lie on the CPU (the twin runs), else the CUDA
    device of ``digits``; raises for any other device."""
    if digits.device.type == "cpu" and bk.device.type == "cpu":
        return None
    if digits.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {digits.device}")
    return digits.device


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
    device = _device_of("ep_contract_rbn", digits_rbn_i8, bk_rows_u32)
    if device is None:
        return ep_contract_rbn_ref(digits_rbn_i8, bk_rows_u32)
    r, b, n = digits_rbn_i8.shape
    c = bk_rows_u32.shape[1]
    check_cuda_operand("digits", digits_rbn_i8, torch.int8, (r, b, n), device)
    check_cuda_operand("bk_rows", bk_rows_u32, torch.int32, (r, c, n), device)
    out = torch.empty((c, NUM_LIMBS, b, n), dtype=torch.int32, device=device)
    KERNEL.launch(ptr(digits_rbn_i8), ptr(bk_rows_u32), ptr(out), r, b, c, n,
                  stream_of(out))
    return out


def ep_contract_ref(digits_i8: torch.Tensor, bk_u32: torch.Tensor) -> torch.Tensor:
    """Plain twin of Kernel H: ``ops/poly.py:ep_contract_matmul``, the same
    layout and the same raw sums."""
    return ep_contract_matmul(digits_i8, bk_u32)


def ep_contract(digits_i8: torch.Tensor, bk_u32: torch.Tensor) -> torch.Tensor:
    """digits int8[B, R, N] x one GGSW u32[R, C, N] -> int32[B, C*4, N]:
    out[b,c*4+l,o] = sum_{r,m} d[b,r,m] * limb_l(+-g[r,c,(o-m)%N]), the sign
    applied in u32 before the limb split (Kernel H)."""
    device = _device_of("ep_contract", digits_i8, bk_u32)
    if device is None:
        return ep_contract_ref(digits_i8, bk_u32)
    b, r, n = digits_i8.shape
    c = bk_u32.shape[1]
    check_cuda_operand("digits", digits_i8, torch.int8, (b, r, n), device)
    check_cuda_operand("ggsw", bk_u32, torch.int32, (r, c, n), device)
    out = torch.empty((b, c * NUM_LIMBS, n), dtype=torch.int32, device=device)
    BATCH_KERNEL.launch(ptr(digits_i8), ptr(bk_u32), ptr(out), r, b, c, n, stream_of(out))
    return out
