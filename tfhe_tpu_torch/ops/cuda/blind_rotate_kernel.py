"""The whole-scan blind rotations: counterparts of the four entry points of
``tfhe_tpu/ops/pallas/blind_rotate_kernel.py``, each with its own
hand-written kernel and plain twin.

  * ``blind_rotate_fused`` — Kernel B (``csrc/blind_rotate_kernel.cu``, int8
    tensor cores on the limb planes of ``csrc/limb_planes.cuh``): both digit
    conventions, ``key_limbs`` 4 (exact) or 3 (impls 'fused', 'fusedb',
    'fused3', 'fusedb3');
  * ``blind_rotate_fused_pipe`` — Kernel E (``csrc/pipe_kernel.cu``, Kernel
    B's contraction in consumer warps fed by producer warps that build the
    limb planes and the next step's digits): carry-chain digits,
    ``key_limbs`` 4 or 3 ('fusedp', 'fusedp3');
  * ``blind_rotate_fused_wide_pipe`` — Kernel F (``csrc/wide_pipe_kernel.cu``):
    both digit conventions, exact key ('fusedw', 'fusedwb');
  * ``blind_rotate_fused_cols`` — Kernel G (``csrc/cols_kernel.cu``, a
    thread-block cluster per sample group): carry-chain digits,
    ``key_limbs`` 4 or 3 ('fusedc', 'fusedc3').

All four compute the same step (``csrc/whole_scan.cuh``), so at one digit
convention and key width they agree bit for bit; they differ in schedule
only: all four share one int8 tensor-core contraction
(``csrc/mma_row.cuh``: limb sums recombined mod 2^32) and take N a power of
two from 64 to 4096 (``MMA_DEGREES``).  Up to N=512 a key row's limb planes
are staged whole; above it the circulant runs in 512 x 512 blocks, each
from a window of the planes of 2*512 entries, so ``large_2048`` and
``large_4096`` fit the shared memory with fewer samples per CTA.
``key_limbs=3`` drops the low byte of each sign-twisted key word, as the TPU
kernels drop their lowest int8 limb plane: an approximate mode that spends
part of the gate's noise margin (PERF.md measures how much at default_128).

Each wrapper launches its kernel for CUDA tensors and runs its plain twin
``*_ref`` for CPU tensors; it raises for anything else.  On the card the
samples per CTA are the largest of ``SAMPLES_PER_CTA`` whose shared memory
fits the card's budget (``_build.smem_budget``); a shape that does not fit
one sample, an N outside ``MMA_DEGREES`` or limb sums that could pass int32
raise ``ValueError`` before anything is launched.  Unlike the
TPU kernels, whose batch lives in VMEM (2048 samples per call for
``fusedp``, 1536 for ``fusedw``), each kernel takes any batch in one launch.
u32 values are int32 tensors (see ``ops/torus.py``).
"""

from __future__ import annotations

import ctypes

import torch

from tfhe_tpu_torch.ops.cuda._build import (
    CudaKernel,
    check_cuda_operand,
    pick_samples_per_cta,
    ptr,
    smem_budget,
    stream_of,
)
from tfhe_tpu_torch.ops.decomposer import (
    balanced_offset,
    decompose_balanced_planes,
    decompose_signed_planes,
)
from tfhe_tpu_torch.ops.poly import ep_combine, ep_contract_matmul, monomial_mul
from tfhe_tpu_torch.params import TfheParams

_INT, _PTR = ctypes.c_int, ctypes.c_void_p
_INFO = ctypes.POINTER(ctypes.c_int)
KERNEL = CudaKernel("blind_rotate_kernel", "blind_rotate_fused",
                    [_PTR] * 4 + [_INT] * 8 + [ctypes.c_uint, _INT, _INT, _INFO, _PTR])
PIPE_KERNEL = CudaKernel("pipe_kernel", "blind_rotate_fused_pipe",
                         [_PTR] * 4 + [_INT] * 9 + [_INFO, _PTR])
WIDE_PIPE_KERNEL = CudaKernel("wide_pipe_kernel", "blind_rotate_fused_wide_pipe",
                              [_PTR] * 4 + [_INT] * 8 + [ctypes.c_uint, _INT, _INFO, _PTR])
COLS_KERNEL = CudaKernel("cols_kernel", "blind_rotate_fused_cols",
                         [_PTR] * 4 + [_INT] * 9 + [_INFO, _PTR])
#: the degrees the four whole-scan kernels take (Kernel B's tensor-core
#: tiles; blocks of BLOCK above BLOCK); their wrappers refuse any other N
#: before a launch
MMA_DEGREES = (64, 128, 256, 512, 1024, 2048, 4096)
BLOCK = 512  # csrc/mma_row.cuh:kBlock
#: the launch plan of each kernel's last launch, by C symbol: samples per
#: CTA, threads per CTA, dynamic shared memory bytes, CTAs (and for Kernel G
#: the clusters the card holds at once)
last_plan: dict = {}


def smem_bytes(kind: str, params: TfheParams, spc: int) -> int:
    """Dynamic shared memory of one CTA of a whole-scan kernel with ``spc``
    samples per CTA, as its C entry point sizes it.  ``kind`` is the C
    symbol's suffix: 'fused', 'pipe', 'wide_pipe' or 'cols'."""
    c, n, levels = params.glwe_dimension + 1, params.degree, params.pbs_decomposer.levels
    r = c * levels
    # one set of 16 byte-shifted limb-plane copies (limb_planes.cuh:copy_words)
    # of a row, or of a block's window above BLOCK, and one whole raw key
    # row; B, F and G keep two of each; digit rows padded by 16 bytes
    # (digit_row_bytes)
    plane_set, raw_row = 4 * 16 * (min(n, BLOCK) // 2 + 8), 4 * n
    planes = 2 * plane_set + 2 * raw_row
    drow = n + 16
    if kind == "fused":
        # accumulators, planes, the digits, the exponents
        return 4 * spc * c * n + planes + r * spc * drow + 4 * spc
    if kind == "pipe":
        # accumulators, a ring of 3 plane buffers, two raw rows, Kernel F's
        # ring of 2C-1 poly slots of digits, the mbarriers (full and empty
        # per plane buffer, two raw rows, one per column), the exponents of
        # two steps
        return (4 * spc * c * n + 3 * plane_set + 2 * raw_row
                + (2 * c - 1) * levels * spc * drow + 8 * (2 * 3 + 2 + c) + 4 * 2 * spc)
    if kind == "wide_pipe":
        # accumulators, planes, a ring of 2C-1 poly slots of digits, exponents
        # of two steps
        return 4 * spc * c * n + planes + (2 * c - 1) * levels * spc * drow + 4 * 2 * spc
    if kind == "cols":
        # one accumulator plane, planes, own digits of two step parities,
        # the gathered digits, the exponents
        return 4 * spc * n + planes + 2 * levels * spc * drow + r * spc * drow + 4 * spc
    raise ValueError(f"unknown whole-scan kernel {kind!r}")


def _check_key_limbs(key_limbs: int) -> None:
    if key_limbs not in (3, 4):
        raise ValueError(f"key_limbs is 4 (exact) or 3 (truncated), got {key_limbs}")


def blind_rotate_fused_ref(params: TfheParams, acc0: torch.Tensor, bk_u32: torch.Tensor,
                           a_hat: torch.Tensor, balanced: bool = False,
                           key_limbs: int = 4) -> torch.Tensor:
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
        acc = acc + ep_combine(ep_contract_matmul(digits, bk_u32[s], key_limbs), k1)
    return acc


def blind_rotate_fused_pipe_ref(params: TfheParams, acc0: torch.Tensor, bk_u32: torch.Tensor,
                                a_hat: torch.Tensor, key_limbs: int = 4) -> torch.Tensor:
    """Plain twin of Kernel E: the per-step loop with carry-chain digits."""
    return blind_rotate_fused_ref(params, acc0, bk_u32, a_hat, False, key_limbs)


def blind_rotate_fused_wide_pipe_ref(params: TfheParams, acc0: torch.Tensor,
                                     bk_u32: torch.Tensor, a_hat: torch.Tensor,
                                     balanced: bool = False) -> torch.Tensor:
    """Plain twin of Kernel F: the per-step loop with the exact key."""
    return blind_rotate_fused_ref(params, acc0, bk_u32, a_hat, balanced, 4)


def blind_rotate_fused_cols_ref(params: TfheParams, acc0: torch.Tensor, bk_u32: torch.Tensor,
                                a_hat: torch.Tensor, key_limbs: int = 4) -> torch.Tensor:
    """Plain twin of Kernel G: the per-step loop with carry-chain digits."""
    return blind_rotate_fused_ref(params, acc0, bk_u32, a_hat, False, key_limbs)


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _launch(kernel: CudaKernel, kind: str, params: TfheParams, acc0: torch.Tensor,
            bk_u32: torch.Tensor, a_hat: torch.Tensor, *mode) -> torch.Tensor:
    """Check the operands, pick the samples per CTA and launch ``kernel``
    with arguments (pointers, shape, decomposer, *mode, spc, info, stream)."""
    device = acc0.device
    b, k1, n = acc0.shape
    dp = params.pbs_decomposer
    if n not in MMA_DEGREES:
        raise ValueError(f"{kernel.symbol} takes N a power of two from 64 to 4096 (Kernel B's "
                         f"tensor-core tiles and blocks), got N={n}")
    # the limb sums of a column run over R*N digits of at most 2^log_base (the
    # carry chain's +B) times limbs of at most 128, in int32
    if k1 * dp.levels * n * (1 << dp.log_base) * 128 >= 1 << 31:
        raise ValueError(f"{kernel.symbol}: R*N = {k1 * dp.levels * n} products of digits up to "
                         f"{1 << dp.log_base} by limbs up to 128 could pass int32")
    if device.type != "cuda":
        raise ValueError(f"{kernel.symbol} runs on CPU or CUDA tensors, got {device}")
    steps = bk_u32.shape[0]
    check_cuda_operand("acc0", acc0, torch.int32, (b, k1, n), device)
    check_cuda_operand("bk_u32", bk_u32, torch.int32, (steps, k1 * dp.levels, k1, n), device)
    check_cuda_operand("a_hat", a_hat, torch.int32, (steps, b), device)
    if bk_u32.data_ptr() % 16:
        raise ValueError(f"bk_u32 must be 16-byte aligned ({kernel.symbol} copies it in 16-byte "
                         "pieces)")
    budget = smem_budget(device)
    spc = pick_samples_per_cta(lambda s: smem_bytes(kind, params, s), budget)
    if spc is None:
        raise ValueError(f"{kernel.symbol}: one sample needs {smem_bytes(kind, params, 1)} "
                         f"bytes of shared memory, over the card's {budget}")
    out = torch.empty_like(acc0)
    info = (ctypes.c_int * 5)()
    with torch.cuda.device(device):  # the C entry point works on the current device
        kernel.launch(ptr(acc0), ptr(bk_u32), ptr(a_hat), ptr(out), steps, b, k1, n, dp.levels,
                      dp.log_base, dp.ignored_bits, *mode, spc, info, stream_of(out))
    plan = dict(samples_per_cta=info[0], threads=info[1], smem_bytes=info[2], ctas=info[3])
    if kind == "cols":
        plan["max_active_clusters"] = info[4]
    last_plan[kernel.symbol] = plan
    return out


def blind_rotate_fused(params: TfheParams, acc0: torch.Tensor, bk_u32: torch.Tensor,
                       a_hat: torch.Tensor, balanced: bool = False,
                       key_limbs: int = 4) -> torch.Tensor:
    """acc0 u32[B, k+1, N], bk u32[n, R, k+1, N] (canonical rows), a_hat
    int32[n, B] -> the final accumulator u32[B, k+1, N].  ``balanced``
    selects the closed-form balanced digits over the reference carry chain;
    ``key_limbs=3`` the truncated key."""
    _check_key_limbs(key_limbs)
    if _on_cpu(acc0, bk_u32, a_hat):
        return blind_rotate_fused_ref(params, acc0, bk_u32, a_hat, balanced, key_limbs)
    return _launch(KERNEL, "fused", params, acc0, bk_u32, a_hat, int(balanced),
                   balanced_offset(params.pbs_decomposer), key_limbs)


def blind_rotate_fused_pipe(params: TfheParams, acc0: torch.Tensor, bk_u32: torch.Tensor,
                            a_hat: torch.Tensor, key_limbs: int = 4) -> torch.Tensor:
    """Kernel E: as ``blind_rotate_fused`` with carry-chain digits; its
    consumer warps only contract, while producer warps build each key row's
    limb planes and step s+1's digits as step s's columns finish."""
    _check_key_limbs(key_limbs)
    if _on_cpu(acc0, bk_u32, a_hat):
        return blind_rotate_fused_pipe_ref(params, acc0, bk_u32, a_hat, key_limbs)
    return _launch(PIPE_KERNEL, "pipe", params, acc0, bk_u32, a_hat, key_limbs)


def blind_rotate_fused_wide_pipe(params: TfheParams, acc0: torch.Tensor, bk_u32: torch.Tensor,
                                 a_hat: torch.Tensor, balanced: bool = False) -> torch.Tensor:
    """Kernel F: as ``blind_rotate_fused`` with the exact key, each poly's
    next-step digits built under the next column's contraction.  (The JAX
    function's ``key_limbs`` is left out: no impl sets it.)"""
    if _on_cpu(acc0, bk_u32, a_hat):
        return blind_rotate_fused_wide_pipe_ref(params, acc0, bk_u32, a_hat, balanced)
    return _launch(WIDE_PIPE_KERNEL, "wide_pipe", params, acc0, bk_u32, a_hat, int(balanced),
                   balanced_offset(params.pbs_decomposer))


def blind_rotate_fused_cols(params: TfheParams, acc0: torch.Tensor, bk_u32: torch.Tensor,
                            a_hat: torch.Tensor, key_limbs: int = 4) -> torch.Tensor:
    """Kernel G: as ``blind_rotate_fused`` with carry-chain digits, one
    thread-block cluster of k+1 CTAs per sample group, one CTA per column."""
    _check_key_limbs(key_limbs)
    if _on_cpu(acc0, bk_u32, a_hat):
        return blind_rotate_fused_cols_ref(params, acc0, bk_u32, a_hat, key_limbs)
    return _launch(COLS_KERNEL, "cols", params, acc0, bk_u32, a_hat, key_limbs)
