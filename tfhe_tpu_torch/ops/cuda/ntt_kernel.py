"""Kernel D: the whole-scan block-NTT blind rotation (counterpart of
``tfhe_tpu/ops/pallas/ntt_kernel.py:blind_rotate_nttf``), serving
``impl='nttf'``.

The key is the lhs form of the NTT-domain key (``ops/ntt.py:ntt_key_lhs_form``,
built once by ``models.keys.with_ntt_lhs_key``), the same bytes as the JAX
package's.  The digits are the reference carry-chain digits (those of
``impl='fused'``), and every residue is exact, so the result equals
``impl='fused'`` bit for bit.

``blind_rotate_nttf`` launches ``csrc/ntt_kernel.cu`` for CUDA tensors and
runs its plain twin ``blind_rotate_nttf_ref`` for CPU tensors; it raises for
anything else.  The kernel runs its three products on int8 ``mma.sync``
with the transforms' operands as mma fragments (``kernel_tables``), each
phase of a step for both CRT primes at once where their blocks fit the
shared memory (else one prime a pass, as at ``large_2048``), and splits
each step's bins, with their key slices, over the CTAs of a thread-block
cluster, which exchange the transformed digits and products in
distributed shared memory, once each a pass.  It keeps no
batch-sized state beyond its CTAs' shared memory, so unlike the TPU kernel
(1536 samples per call, a VMEM limit) it takes any batch in one launch.
u32 values are int32 tensors (see ``ops/torus.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tfhe_tpu_torch.ops import ntt
from tfhe_tpu_torch.ops.cuda._build import CudaKernel, check_cuda_operand, ptr, stream_of
from tfhe_tpu_torch.ops.decomposer import decompose_signed_planes
from tfhe_tpu_torch.ops.poly import monomial_mul
from tfhe_tpu_torch.params import TfheParams
from tfhe_tpu_torch.utils.profiling import count

KERNEL = CudaKernel(
    "ntt_kernel", "blind_rotate_nttf",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.POINTER(ctypes.c_int),
                                                    ctypes.c_void_p],
)
#: the launch plan of the last launch: samples per CTA, threads per CTA,
#: dynamic shared memory bytes, CTAs, the CTAs of a cluster, which split the
#: bins (``split``), the clusters the card holds at once, key stages,
#: contraction m-tiles per stage, whether the outgoing Dh and Ch blocks
#: share their room (1 where the shared memory is short) and the exchanges
#: between the CTAs of a cluster a step (2: Dh and Ch, each of both primes;
#: 4 where both primes' blocks do not fit and a step runs one prime a pass)
last_plan: dict = {}
PLAN_KEYS = ("samples_per_cta", "threads", "smem_bytes", "ctas", "split",
             "max_active_clusters", "key_stages", "mtiles_per_stage", "shared_out_blocks",
             "exchanges_per_step")
#: the mma fragments' rows per tile and K per mma (m16n8k32)
FRAG_ROWS, FRAG_K = 8, 32


def lhs_key_shape(params: TfheParams, plan: ntt.NttPlan, steps: int) -> tuple:
    """The shape of the lhs-form key: [steps, P, N1, 2*C*L*N2, R*N2]."""
    k1 = params.glwe_dimension + 1
    rn2 = k1 * params.pbs_decomposer.levels * plan.n2
    return (steps, len(ntt.PRIMES), plan.n1, 2 * k1 * plan.key_limbs * plan.n2, rn2)


def fragment_layout(mat: torch.Tensor) -> torch.Tensor:
    """int32 [N1, N1] (row, k) -> int8 [N1/8 tiles, 32 lanes, N1/32 k-steps,
    4 registers, 4 bytes]: the A operands of ``mma.sync.m16n8k32`` whose
    rows 0-7 are the hi bytes and rows 8-15 the lo bytes of rows 8t..8t+7 of
    ``mat`` (balanced bytes, ``ntt.split2_i8``).  Lane = 4*g + c holds in
    register 0 hi[8t+g, 32s+4c .. +3], 1 the same of lo, 2 and 3 those at
    k + 16."""
    n1 = mat.shape[0]
    hi, lo = ntt.split2_i8(mat)
    planes = torch.stack([hi, lo])  # [plane, row, k]
    t = torch.arange(n1 // FRAG_ROWS)[:, None, None, None, None]
    lane = torch.arange(32)[None, :, None, None, None]
    step = torch.arange(n1 // FRAG_K)[None, None, :, None, None]
    reg = torch.arange(4)[None, None, None, :, None]
    byte = torch.arange(4)[None, None, None, None, :]
    row = FRAG_ROWS * t + lane // 4
    k = FRAG_K * step + 16 * (reg // 2) + 4 * (lane % 4) + byte
    return planes[reg % 2, row, k]


@functools.lru_cache(maxsize=None)
def kernel_tables(n1: int, device: torch.device) -> torch.Tensor:
    """int8 [P, 2, N1/8, 32, N1/32, 4, 4]: per prime the mma fragments
    (``fragment_layout``) of w_fwd transposed ([bin][i], the forward's A)
    and of w_inv transposed ([i][bin], the inverse's A), built once per
    device."""
    frags = [fragment_layout(torch.from_numpy(t[name]).T.contiguous())
             for t in ntt._tables(n1) for name in ("w_fwd", "w_inv")]
    return torch.stack(frags).reshape(len(ntt.PRIMES), 2, *frags[0].shape).to(device)


def blind_rotate_nttf_ref(params: TfheParams, acc0: torch.Tensor, bk_lhs: torch.Tensor,
                          a_hat: torch.Tensor) -> torch.Tensor:
    """Plain twin.  Per step: rotate, take the reference carry-chain digits
    in canonical row order (poly*levels + level), contract them with
    ``ep_contract_ntt`` against the step's key in the form ``make_ep_ntt_key``
    gives, and add the result to the accumulator."""
    dp = params.pbs_decomposer
    plan = ntt.plan_for_params(params)
    b, k1, n = acc0.shape
    acc = acc0
    for s in range(bk_lhs.shape[0]):
        rot = monomial_mul(acc, a_hat[s][:, None])
        digits = decompose_signed_planes(rot - acc, dp)  # [levels, B, k+1, N]
        digits = digits.permute(1, 2, 0, 3).reshape(b, k1 * dp.levels, n)
        acc = acc + ntt.ep_contract_ntt(digits, ntt.ntt_key_rhs_form(bk_lhs[s]), plan, k1)
    return acc


def blind_rotate_nttf(params: TfheParams, acc0: torch.Tensor, bk_lhs: torch.Tensor,
                      a_hat: torch.Tensor, plan: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """acc0 u32[B, k+1, N]; bk_lhs int8[n, P, N1, 2*CLN2, RN2]
    (``ServerKey.bk_ntt_lhs``); a_hat int32[n, B] -> the final accumulator
    u32[B, k+1, N].  ``plan`` = (samples per CTA: 1, 2 or 4; split: 1, 2, 4
    or 8, see ``last_plan``) forces the kernel's plan, 0 lets it pick; the
    CPU twin ignores it.  On the card each launch adds steps x
    ``exchanges_per_step`` to the counter ``pbs.nttf_exchanges`` (while a
    profiler runs)."""
    if all(t.device.type == "cpu" for t in (acc0, bk_lhs, a_hat)):
        return blind_rotate_nttf_ref(params, acc0, bk_lhs, a_hat)
    device = acc0.device
    if device.type != "cuda":
        raise ValueError(f"blind_rotate_nttf runs on CPU or CUDA tensors, got {device}")
    b, k1, n = acc0.shape
    steps = bk_lhs.shape[0]
    dp = params.pbs_decomposer
    nplan = ntt.plan_for_params(params)
    check_cuda_operand("acc0", acc0, torch.int32, (b, k1, n), device)
    check_cuda_operand("bk_lhs", bk_lhs, torch.int8, lhs_key_shape(params, nplan, steps), device)
    check_cuda_operand("a_hat", a_hat, torch.int32, (steps, b), device)
    if bk_lhs.data_ptr() % 16:
        raise ValueError("bk_lhs must be 16-byte aligned")
    tables = kernel_tables(nplan.n1, device)
    out = torch.empty_like(acc0)
    info = (ctypes.c_int * len(PLAN_KEYS))()
    with torch.cuda.device(device):  # the C entry point works on the current device
        KERNEL.launch(ptr(acc0), ptr(bk_lhs), ptr(a_hat), ptr(tables), ptr(out), steps, b, k1,
                      n, dp.levels, dp.log_base, dp.ignored_bits, nplan.n1, nplan.key_bits,
                      nplan.key_limbs, *plan, info, stream_of(out))
    last_plan.clear()
    last_plan.update(zip(PLAN_KEYS, info))
    count("pbs.nttf_exchanges", steps * last_plan["exchanges_per_step"])
    return out
