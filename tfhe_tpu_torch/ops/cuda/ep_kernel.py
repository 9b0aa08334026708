"""The external-product contraction kernels, both over ``csrc/ep_contract.cuh``:

  * Kernel A, ``ep_contract_rbn`` (``csrc/ep_kernel.cu``; counterpart of
    ``tfhe_tpu/ops/pallas/ep_kernel.py:ep_contract_pallas_rbn``): the
    per-step contraction of the ``pallas`` and ``bmmp`` scans, digits
    [R, B, N] -> limb planes [C, 4, B, N];
  * Kernel H, ``ep_contract`` (``csrc/ep_batch_kernel.cu``; counterpart of
    ``ep_contract_pallas``): the batch-major contraction of the ``conv``
    scan and of ``models/ggsw.external_product``, digits [B, R, N] -> limb
    sums [B, C*4, N].

Design (the header comment of ``ep_contract.cuh`` has the whole of it): the
int8 sums run on the tensor cores as ``mma.sync`` m16n8k32, samples as M,
outputs as N, input coefficients as K.  The key's circulant is never built:
each B-fragment register is one 32-bit shared load from one of four
byte-shifted copies of a limb plane of ``[g, -g]``.  A CTA owns up to 32
samples, one column, 16 outputs per warp and all four limbs; when those
tiles are too few to fill the card, the rows are split over a thread-block
cluster whose CTAs sum their partial tiles over distributed shared memory.

The plan (samples per CTA, warps, row split, digit buffers, shared memory)
is chosen in Python by the pure function ``ep_plan`` from the shape and the
card's SM count and opt-in shared memory, like ``pick_samples_per_cta`` for
Kernel B; the C entry points check it.  ``last_plan`` holds each kernel's
plan of its last launch, by C symbol, with the shared memory and CTAs its C
entry point reported.

Each wrapper launches its kernel for CUDA tensors and runs its plain twin
for CPU tensors; it raises for anything else.  u32 key words are int32
tensors (see ``ops/torus.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tfhe_tpu_torch.ops.cuda._build import (
    CudaKernel,
    check_cuda_operand,
    ptr,
    sm_count,
    smem_budget,
    stream_of,
)
from tfhe_tpu_torch.ops.poly import NUM_LIMBS, ep_contract_matmul

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
             + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
KERNEL = CudaKernel("ep_kernel", "ep_contract_rbn", _ARGTYPES)
BATCH_KERNEL = CudaKernel("ep_batch_kernel", "ep_contract", _ARGTYPES)
#: the plan of each kernel's last launch, by C symbol (``ep_plan``'s keys,
#: with ``smem_bytes`` and ``ctas`` as the C entry point reported them)
last_plan: dict = {}

#: the smallest degree the kernels take (two warps of 16 outputs)
MIN_N = 32
#: CTAs of one row-split cluster at most (the portable cluster size)
MAX_SPLIT = 8
#: samples per CTA, preferred first
SAMPLES_PER_CTA = (32, 16)
#: CTAs per SM the row split aims for
CTAS_PER_SM = 2


def smem_bytes(n: int, bm: int, warps: int, nbuf: int) -> int:
    """Dynamic shared memory of one CTA, as ``ep_contract.cuh:smem_bytes``
    sizes it: 16 byte-shifted limb-plane copies of N/2 + 8 words, ``nbuf``
    buffers of ``bm`` digit rows of N + 16 bytes and the raw key row, or the
    int32 partial tile [4, bm, 16*warps + 8] if that is larger."""
    stage = 4 * NUM_LIMBS * 4 * (n // 2 + 8) + nbuf * bm * (n + 16) + 4 * n
    return max(stage, 4 * NUM_LIMBS * bm * (16 * warps + 8))


def ep_plan(b: int, r: int, c: int, n: int, sms: int, budget: int) -> dict:
    """The launch plan of Kernels A and H for digits of B samples and R rows
    against C columns of degree N, on a card of ``sms`` SMs whose blocks may
    take ``budget`` bytes of shared memory.

    A CTA owns ``samples_per_cta`` samples (32, or 16 when B <= 16 or 32 do
    not fit), one column, ``outputs_per_cta`` = 16 * warps outputs and all 4
    limbs, with two digit buffers where they fit.  The R rows are split over
    a cluster of ``split`` CTAs (at most 8) of ``rows_per_split`` rows each,
    the fewest that give every SM two CTAs.  These choices were the fastest
    of those timed on an H100 at default_128, B = 1 .. 1024 (PERF.md).
    Raises ValueError for a shape the kernels do not take or no plan fits."""
    if n < MIN_N or n & (n - 1):
        raise ValueError(f"the contraction kernels take N a power of two >= {MIN_N}, got {n}")
    if min(b, r, c) < 1:
        raise ValueError(f"B, R and C must be >= 1, got {b}, {r}, {c}")
    warps = min(4, n // 16)
    to = 16 * warps
    fits = [(bm, nbuf) for bm in SAMPLES_PER_CTA if bm == 16 or b > 16 for nbuf in (2, 1)
            if smem_bytes(n, bm, warps, nbuf) <= budget]
    if not fits:
        raise ValueError(f"no plan of the contraction kernels fits {budget} bytes of shared "
                         f"memory at N={n} (16 samples take "
                         f"{smem_bytes(n, 16, warps, 1)})")
    bm, nbuf = fits[0]
    tiles = -(-b // bm) * (n // to) * c
    split = min(MAX_SPLIT, r, max(1, -(-CTAS_PER_SM * sms // tiles)))
    rows_per = -(-r // split)
    split = -(-r // rows_per)
    return dict(samples_per_cta=bm, warps=warps, outputs_per_cta=to, split=split,
                rows_per_split=rows_per, digit_buffers=nbuf,
                smem_bytes=smem_bytes(n, bm, warps, nbuf), ctas=split * tiles)


@functools.lru_cache(maxsize=None)
def _plan_on(b: int, r: int, c: int, n: int, device: torch.device) -> dict:
    return ep_plan(b, r, c, n, sm_count(device), smem_budget(device))


def _device_of(name: str, digits: torch.Tensor, bk: torch.Tensor) -> torch.device | None:
    """None when both operands lie on the CPU (the twin runs), else the CUDA
    device of ``digits``; raises for any other device."""
    if digits.device.type == "cpu" and bk.device.type == "cpu":
        return None
    if digits.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {digits.device}")
    return digits.device


def _launch(kernel: CudaKernel, digits: torch.Tensor, bk: torch.Tensor, out: torch.Tensor,
            r: int, b: int, c: int, n: int) -> None:
    """Plan, check alignment (the kernels copy 16 bytes at a time) and launch."""
    for name, t in (("digits", digits), ("bk", bk)):
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel.symbol}: {name} must be 16-byte aligned")
    plan = _plan_on(b, r, c, n, out.device)
    info = (ctypes.c_int * 2)()
    with torch.cuda.device(out.device):  # the C entry point works on the current device
        kernel.launch(ptr(digits), ptr(bk), ptr(out), r, b, c, n, plan["samples_per_cta"],
                      plan["warps"], plan["split"], plan["rows_per_split"],
                      plan["digit_buffers"], info, stream_of(out))
    last_plan[kernel.symbol] = dict(plan, smem_bytes=info[0], ctas=info[1])


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
    _launch(KERNEL, digits_rbn_i8, bk_rows_u32, out, r, b, c, n)
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
    _launch(BATCH_KERNEL, digits_i8, bk_u32, out, r, b, c, n)
    return out
