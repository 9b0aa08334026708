"""Kernel C: the small-batch whole-scan blind rotation (counterpart of
``tfhe_tpu/ops/pallas/latency_kernel.py:blind_rotate_latency``), serving
``impl='fusedl'`` (V=1, B <= 8) and the BMMP halved-depth ``impl='bmmpl'``
(V=3, B <= 4).

The circulant expansion sits on the digit side: per step, the key rides as
int8 limb rows K[(col, limb), (g, t, lane)] (``bk_latency_operand``, the same
bytes as the JAX package's operand) and each sample's digit rows are
contracted negacyclically against it.  The kernel does it on int8 tensor
cores, one thread-block cluster per sample, its CTAs splitting the key
columns and each owning a slice of the accumulator's coefficients.  Every
CTA also keeps the whole accumulator in shared memory and makes the digit
words its key columns read from it, so a step takes two exchanges between
the CTAs' shared memories and no cluster barrier: the partial deltas added
into their owners' slices, and each owner's slice copied into every CTA
(see the source for why each buffer is safe without a barrier).

``blind_rotate_latency`` launches ``csrc/latency_kernel.cu`` for CUDA tensors
and runs its plain twin ``blind_rotate_latency_ref`` for CPU tensors; it
raises for anything else.  u32 values are int32 tensors (see
``ops/torus.py``).
"""

from __future__ import annotations

import ctypes

import torch

from tfhe_tpu_torch.ops.cuda._build import CudaKernel, check_cuda_operand, ptr, stream_of
from tfhe_tpu_torch.ops.decomposer import decompose_signed_planes
from tfhe_tpu_torch.ops.poly import (
    NUM_LIMBS,
    ep_combine,
    level_major_row_perm,
    monomial_mul,
    sign_toeplitz_small,
)
from tfhe_tpu_torch.ops.torus import int_matmul, to_signed_limbs
from tfhe_tpu_torch.params import TfheParams

#: the latency path is the small-batch path; beyond this the throughput
#: kernels (``fused``/``fusedb``) serve the batch
MAX_LATENCY_BATCH = 8
#: the BMMP variant contracts 3x as many digit rows per step
MAX_LATENCY_BATCH_BMMP = 4

KERNEL = CudaKernel(
    "latency_kernel", "blind_rotate_latency",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p],
)
#: the keys of ``last_plan``, in the order the C entry point reports them
PLAN_KEYS = ("cluster", "threads", "smem_bytes", "max_active_clusters", "ctas", "stages",
             "k_splits", "exchanges")
#: the launch plan of the last launch: cluster size (CTAs per sample),
#: threads per CTA, dynamic shared memory bytes, the clusters of that size
#: the card can hold at once (``cudaOccupancyMaxActiveClusters``), CTAs, key
#: stages in the ring, the k-splits of a CTA's key columns among its
#: consumer warps and the cluster-wide exchanges a step (a fixed tag of the
#: one schedule the kernel runs, always 2: the kernel reports it, it does not
#: measure it)
last_plan: dict = {}


def n_groups(params: TfheParams, variants: int) -> int:
    """G = ceil(R_tot / 4): digit rows packed four to a group."""
    return -(-variants * (params.glwe_dimension + 1) * params.pbs_decomposer.levels // 4)


def bk_latency_operand(bk_u32: torch.Tensor) -> torch.Tensor:
    """Canonical-row-order key u32[steps, R_tot, k+1, N] (the BK itself, or
    the BMMP triples reordered) -> the kernel's int8 key operand
    [steps, (k+1)*4, 4*G*N]: rows (col, limb), columns (g, t, lane), rows of
    the last group zero-padded to 4*G."""
    steps, r_tot, k1, n = bk_u32.shape
    g_tot = -(-r_tot // 4)
    limbs = to_signed_limbs(bk_u32)  # int8[steps, R, k+1, N, 4]
    x = limbs.permute(0, 2, 4, 1, 3)  # [steps, k+1, limb, R, N]
    pad = g_tot * 4 - r_tot
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    x = x.reshape(steps, k1, NUM_LIMBS, g_tot, 4, n).transpose(-1, -2)  # [.., G, N(t), lane]
    return x.reshape(steps, k1 * NUM_LIMBS, g_tot * 4 * n).contiguous()


def bk_latency_operand_bmmp(bk_bmmp_lm: torch.Tensor, params: TfheParams) -> torch.Tensor:
    """BMMP key triples u32[n/2, 3R, k+1, N] (level-major rows per GGSW,
    ``ServerKey.bk_bmmp_lm``) -> the kernel's int8 key operand with 3R
    canonical-order rows per step, variant-major (ss', s(1-s'), (1-s)s')."""
    k1 = params.glwe_dimension + 1
    levels = params.pbs_decomposer.levels
    steps, r3, _, n = bk_bmmp_lm.shape
    r = k1 * levels
    if r3 != 3 * r:
        raise ValueError(f"BMMP key has {r3} rows per step, expected {3 * r}")
    inv = torch.as_tensor(level_major_row_perm(k1, levels).argsort(),
                          device=bk_bmmp_lm.device)  # level-major -> canonical
    x = bk_bmmp_lm.reshape(steps, 3, r, k1, n)[:, :, inv]
    return bk_latency_operand(x.reshape(steps, 3 * r, k1, n))


def check_batch(batch: int, variants: int) -> None:
    """Raise ValueError unless V is 1 or 3 and B is within its cap."""
    if variants not in (1, 3):
        raise ValueError(f"the latency kernel takes 1 or 3 variants, got {variants}")
    cap = MAX_LATENCY_BATCH if variants == 1 else MAX_LATENCY_BATCH_BMMP
    if batch > cap:
        raise ValueError(f"the latency path is the small-batch path (B <= {cap} at "
                         f"V={variants}), got B={batch}; use 'fused'/'fusedb' beyond it")


def blind_rotate_latency_ref(params: TfheParams, acc0: torch.Tensor, bk_lat: torch.Tensor,
                             a_vhat: torch.Tensor) -> torch.Tensor:
    """Plain twin.  Per step: the reference carry-chain digits of
    (acc_p * X^{a_v} - acc_p) for every variant v and poly p (rows
    v*R + p*levels + level, zero-padded to 4*G), contracted as
    out[b, (c,l), j] = sum_{g,t,lane} K[(c,l),(g,t,lane)] * +-d_{4g+lane}[(j-t) mod N]
    (minus where j < t), recombined as sum_l out << 8l (wrapping) and added
    to acc."""
    dp = params.pbs_decomposer
    b, k1, n = acc0.shape
    steps, variants = a_vhat.shape[:2]
    g_tot = bk_lat.shape[-1] // (4 * n)
    rows = g_tot * 4
    acc = acc0
    for s in range(steps):
        blocks = []
        for v in range(variants):
            rot = monomial_mul(acc, a_vhat[s, v][:, None])
            digits = decompose_signed_planes(rot - acc, dp)  # [levels, B, k+1, N]
            blocks.append(digits.permute(1, 2, 0, 3).reshape(b, k1 * dp.levels, n))
        d = torch.cat(blocks, dim=1)
        d = torch.nn.functional.pad(d, (0, 0, 0, rows - d.shape[1]))  # [B, 4G, N]
        circ = sign_toeplitz_small(d).reshape(b, rows * n, n)  # [B, (r, t), j]
        kmat = bk_lat[s].reshape(k1 * NUM_LIMBS, g_tot, n, 4).transpose(-1, -2)
        out = int_matmul(kmat.reshape(k1 * NUM_LIMBS, rows * n), circ)  # [B, (c,l), N]
        acc = acc + ep_combine(out, k1)
    return acc


def blind_rotate_latency(params: TfheParams, acc0: torch.Tensor, bk_lat: torch.Tensor,
                         a_vhat: torch.Tensor, cluster: int = 0) -> torch.Tensor:
    """acc0 u32[B, k+1, N]; bk_lat from ``bk_latency_operand`` (V=1, B <= 8)
    or ``bk_latency_operand_bmmp`` (V=3, B <= 4); a_vhat int32[steps, V, B]
    (V=1: the mod-switched mask; V=3: rows (a+a', a, a') mod 2N per pair)
    -> the final accumulator u32[B, k+1, N].  ``cluster`` (16, 8, 4, 2 or 1
    CTAs per sample, see ``last_plan``) forces the kernel's cluster size, 0
    lets it pick; the CPU twin ignores it."""
    b, k1, n = acc0.shape
    steps, variants = a_vhat.shape[:2]
    check_batch(b, variants)
    if all(t.device.type == "cpu" for t in (acc0, bk_lat, a_vhat)):
        return blind_rotate_latency_ref(params, acc0, bk_lat, a_vhat)
    device = acc0.device
    if device.type != "cuda":
        raise ValueError(f"blind_rotate_latency runs on CPU or CUDA tensors, got {device}")
    dp = params.pbs_decomposer
    width = 4 * n_groups(params, variants) * n
    check_cuda_operand("acc0", acc0, torch.int32, (b, k1, n), device)
    check_cuda_operand("bk_lat", bk_lat, torch.int8, (steps, k1 * NUM_LIMBS, width), device)
    check_cuda_operand("a_vhat", a_vhat, torch.int32, (steps, variants, b), device)
    if bk_lat.data_ptr() % 16:
        raise ValueError("bk_lat must be 16-byte aligned")
    out = torch.empty_like(acc0)
    info = (ctypes.c_int * len(PLAN_KEYS))()
    with torch.cuda.device(device):  # the C entry point works on the current device
        KERNEL.launch(ptr(acc0), ptr(bk_lat), ptr(a_vhat), ptr(out), steps, b, variants, k1, n,
                      dp.levels, dp.log_base, dp.ignored_bits, cluster, info, stream_of(out))
    last_plan.clear()
    last_plan.update(zip(PLAN_KEYS, info))
    return out
