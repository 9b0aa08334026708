"""GGSW ciphertexts, external product and CMUX (port of
``tfhe_tpu/models/ggsw.py``; reference: src/ggsw.rs).

GGSW layout: u32[..., R=(k+1)*levels, k+1, N]; row (i*levels + j) is a GLWE(0)
plus m * B^(l_full-j-1) on the constant coefficient of polynomial i
(src/ggsw.rs:43-103).  The external product decomposes the GLWE into R
signed-digit rows and contracts them against the GGSW, with JAX's two impls:

  * ``conv`` (the default): Kernel H (``ops/cuda/ep_kernel.py:ep_contract``)
    on CUDA tensors, its plain twin on CPU tensors.  It reads the canonical
    u32 GGSW and stages the sign-twisted limbs itself, where JAX's ``conv``
    builds the kernel-reversed int8 form first (``bk_to_conv_kernel``);
  * ``matmul``: the plain Toeplitz formulation
    (``ops/poly.py:ep_contract_matmul``) on any device, the explicit
    reference.

Both give JAX's u32 result bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from tfhe_tpu_torch.models import glwe as mglwe
from tfhe_tpu_torch.ops.cuda.ep_kernel import ep_contract
from tfhe_tpu_torch.ops.poly import ep_combine, ep_contract_matmul
from tfhe_tpu_torch.ops.torus import to_torch_u32, u32
from tfhe_tpu_torch.params import TfheParams


def gadget_matrix(params: TfheParams) -> np.ndarray:
    """u32[R, k+1, N] with G[i*l+j, i, 0] = B^(l_full-j-1) (src/ggsw.rs:90-103)."""
    dp = params.pbs_decomposer
    k = params.glwe_dimension
    gm = np.zeros(((k + 1) * dp.levels, k + 1, params.degree), dtype=np.uint32)
    for i in range(k + 1):
        for j in range(dp.levels):
            gm[i * dp.levels + j, i, 0] = np.uint32(
                (1 << (dp.log_base * (dp.l_full - (j + 1)))) & 0xFFFFFFFF
            )
    return gm


def encrypt(sk_t, message_bits, params: TfheParams, a, e) -> torch.Tensor:
    """Batch-encrypt GGSW(m) for a vector of bit messages (src/ggsw.rs:76-130).

    message_bits: u32[...]; a: u32[..., R, k, N]; e: u32[..., R, N].
    Returns u32[..., R, k+1, N] (one GGSW per LWE secret bit for the
    bootstrapping key, src/bootstrapping.rs:32-38).
    """
    zero = mglwe.encrypt_zero(sk_t, a, e)  # [..., R, k+1, N]
    gm = to_torch_u32(gadget_matrix(params), zero.device)
    m = u32(message_bits, zero.device)[..., None, None, None]
    return zero + m * gm


#: the batch-major contraction of each external-product impl (also the
#: per-step contraction of the 'conv' and 'matmul' blind-rotation scans)
EP_CONTRACTIONS = {"conv": ep_contract, "matmul": ep_contract_matmul}


def external_product(ggsw_u32, glwe_ct, params: TfheParams, impl: str = "conv") -> torch.Tensor:
    """GGSW(m2) x GLWE(m1) -> GLWE(m1*m2) (src/ggsw.rs:132-161), batched over
    the GLWE's leading dims; the GGSW is shared (u32[R, k+1, N]).  ``impl``
    is 'conv' (Kernel H) or 'matmul' (plain); anything else raises."""
    if impl not in EP_CONTRACTIONS:
        raise ValueError(f"unknown impl {impl!r}; valid: {tuple(EP_CONTRACTIONS)}")
    ct = u32(glwe_ct)
    lead = ct.shape[:-2]
    digits = mglwe.decompose(ct, params.pbs_decomposer)
    flat = digits.reshape((-1,) + digits.shape[-2:]).contiguous()  # [B, R, N]
    acc = EP_CONTRACTIONS[impl](flat, u32(ggsw_u32, ct.device).contiguous())
    out = ep_combine(acc, params.glwe_dimension + 1)  # [B, k+1, N]
    return out.reshape(lead + out.shape[-2:])


def cmux(ggsw_u32, c0, c1, params: TfheParams, impl: str = "conv") -> torch.Tensor:
    """b ? c1 : c0 = EP(b, c1-c0) + c0 (src/ggsw.rs:164-178)."""
    c0 = u32(c0)
    return external_product(ggsw_u32, u32(c1) - c0, params, impl=impl) + c0
