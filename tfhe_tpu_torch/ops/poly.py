"""Negacyclic polynomial ops in Z_{2^32}[X]/(X^N+1) (port of ``tfhe_tpu/ops/poly.py``).

The plain formulation of every TFHE product: one side is small (gadget
digits, binary secret bits), the u32 side splits into 4 balanced signed 8-bit
limbs (``ops/torus.py``), and the contraction against the sign-twisted
Toeplitz expansion of the u32 side is an exact small-integer matmul
(``torus.int_matmul``), recombined with wrapping shifts.  These functions are
the plain twins the CUDA kernels under ``ops/cuda/`` are held against.

The external-product contraction has the JAX package's two formulations:
``ep_contract_matmul`` (explicit Toeplitz expansion of the key, the sign
twisted in u32 before the limb split; the twin of Kernels A and H) and
``ep_contract_conv`` (one convolution over the negacyclically extended
digits against the kernel-reversed key limbs).  Their raw limb sums differ
where the sign lands; after ``ep_combine`` they agree mod 2^32.

u32 values are int32 tensors (see ``ops/torus.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from tfhe_tpu_torch.ops.torus import (
    combine_limb_accs,
    int_matmul,
    to_signed_limbs,
    u32,
)

NUM_LIMBS = 4


def monomial_mul(poly, exp) -> torch.Tensor:
    """poly(X) * X^exp with negacyclic wraparound (src/utils.rs:183-207).

    ``poly``: u32[..., N]; ``exp``: integer(s) broadcastable to
    ``poly.shape[:-1]`` (may be negative; reduced mod 2N).  A gather with the
    closed-form sign: out[i] = (-1)^floor(((i-e) mod 2N)/N) * poly[(i-e) mod N].
    """
    poly = u32(poly)
    n = poly.shape[-1]
    e = torch.as_tensor(exp, device=poly.device).to(torch.int64)
    e = torch.broadcast_to(e, poly.shape[:-1]).unsqueeze(-1)
    src = torch.arange(n, device=poly.device) - torch.remainder(e, 2 * n)
    idx = torch.remainder(src, n).expand(poly.shape)
    out = torch.gather(poly, -1, idx)
    return torch.where(torch.remainder(src, 2 * n) >= n, -out, out)


def monomial_mul_custom_mod(poly, exp, log_modulus: int) -> torch.Tensor:
    """``monomial_mul`` with coefficients reduced mod 2^log_modulus
    (src/utils.rs:209-219: poly_mul_monomial_custom_mod); for API parity."""
    out = monomial_mul(poly, exp)
    if log_modulus < 32:
        out = out & ((1 << log_modulus) - 1)
    return out


def _toeplitz_index(n: int, device, o_start=0, n_cols: int | None = None):
    """Index and sign mask of T[m, oo] = +-p[(o-m)%N] for the output columns
    o = o_start + oo, oo in [0, n_cols) (all N columns by default)."""
    m = torch.arange(n, device=device)[:, None]
    o = torch.as_tensor(o_start, device=device).to(torch.int64) + torch.arange(
        n if n_cols is None else n_cols, device=device)[None, :]
    return torch.remainder(o - m, n), m <= o


def sign_toeplitz_u32(p_u32) -> torch.Tensor:
    """u32 poly [..., N] -> u32[..., N(m), N(o)] with T[m,o] = +-p[(o-m)%N].

    Negation happens in u32 (wrapping, exact) BEFORE any limb split: the
    balanced int8 limb -128 cannot be negated in int8.
    """
    p = u32(p_u32)
    idx, keep = _toeplitz_index(p.shape[-1], p.device)
    t = p[..., idx]
    return torch.where(keep, t, -t)


def sign_toeplitz_u32_cols(p_u32, o_start, n_cols: int) -> torch.Tensor:
    """Column slice of ``sign_toeplitz_u32``: T[m, oo] = +-p[(o-m)%N] for
    o = o_start+oo, oo in [0, n_cols).  ``o_start`` is an int or a 0-d
    tensor (the shard offset in the coefficient-sharded external product)."""
    p = u32(p_u32)
    idx, keep = _toeplitz_index(p.shape[-1], p.device, o_start, n_cols)
    t = p[..., idx]
    return torch.where(keep, t, -t)


def sign_toeplitz_small(p_small) -> torch.Tensor:
    """Small-int poly [..., N] -> int8[..., N(m), N(o)] with T[m,o] = +-p[(o-m)%N]
    (contraction-major: ``a[..., m] @ T[m, o]`` is the negacyclic product)."""
    p = torch.as_tensor(p_small).to(torch.int8)
    idx, keep = _toeplitz_index(p.shape[-1], p.device)
    t = p[..., idx]
    return torch.where(keep, t, -t)


def negacyclic_matvec_u32_small(a_u32, t_small) -> torch.Tensor:
    """Exact wrapping contraction a[..., K] x T[K, N] -> u32[..., N] (``a`` full
    u32, limb-split; ``T`` small signed, e.g. stacked sign-Toeplitz blocks of
    binary secret polynomials; src/utils.rs:163-173)."""
    limbs = to_signed_limbs(a_u32).movedim(-1, -2)  # [..., 4, K]
    acc = int_matmul(limbs, t_small)  # [..., 4, N]
    return combine_limb_accs(acc.movedim(-2, -1))


def poly_mul_u32(a, b) -> torch.Tensor:
    """General exact u32 negacyclic product (API parity with src/utils.rs:155-160).

    Both operands full u32: 4x4 signed-limb products keeping i+j<4 (mod 2^32),
    the sign twist applied to ``b`` in u32 before its limb split.  Not on any
    hot path (TFHE products always have a small side).
    """
    la = to_signed_limbs(a)  # [..., N, 4]
    tb = to_signed_limbs(sign_toeplitz_u32(b))  # [..., N, N, 4]
    res = torch.zeros(la.shape[:-1], dtype=torch.int32, device=la.device)
    for j in range(NUM_LIMBS):
        for i in range(NUM_LIMBS - j):
            acc = int_matmul(la[..., None, :, i], tb[..., j])[..., 0, :]
            res = res + (acc << (8 * (i + j)))
    return res


def negacyclic_extend(d) -> torch.Tensor:
    """[..., N] -> [..., 2N] = concat([-d, d]): negacyclic conv becomes VALID conv."""
    return torch.cat([-d, d], dim=-1)


def bk_u32_limbs_to_ocin(limbs) -> torch.Tensor:
    """[..., R, C, N, L] -> [..., C*L, R, N] int8."""
    x = limbs.movedim(-1, -3).transpose(-4, -2)  # [..., C, L, R, N]
    shape = x.shape[:-4] + (x.shape[-4] * x.shape[-3],) + x.shape[-2:]
    return x.reshape(shape).to(torch.int8)


def bk_to_conv_kernel(bk_u32) -> torch.Tensor:
    """GGSW u32[..., R, C, N] -> conv-ready int8[..., C*4, R, N], kernel-reversed,
    out channel f = c*4 + limb (the JAX package's ``ServerKey.bk_conv`` form)."""
    return torch.flip(bk_u32_limbs_to_ocin(to_signed_limbs(bk_u32)), dims=(-1,))


def ep_contract_conv(digits_i8, bk_kernel_i8) -> torch.Tensor:
    """The contraction as one VALID convolution over the negacyclically
    extended digits: digits int8[B, R, N] x ``bk_to_conv_kernel`` int8[F, R, N]
    -> int32[B, F, N], out[b,f,o] = sum_{r,m} +-digits[b,r,(o-m)%N] * limb_f(g[r,m]).

    The sign rides on the digits, not on the key word, so the raw sums differ
    from ``ep_contract_matmul``'s; after ``ep_combine`` they agree mod 2^32.
    The convolution runs in float64, exact while every sum stays below 2^53.
    """
    n = digits_i8.shape[-1]
    lhs = negacyclic_extend(digits_i8.to(torch.float64))  # [B, R, 2N]
    out = torch.nn.functional.conv1d(lhs, bk_kernel_i8.to(torch.float64))  # [B, F, N+1]
    return out[..., 1:n + 1].to(torch.int64).to(torch.int32)


def bk_to_matmul_w(bk_u32, key_limbs: int = NUM_LIMBS) -> torch.Tensor:
    """GGSW u32[R, C, N] -> Toeplitz weights int8[R*N(m), C*4*N(o)].

    W[(r,m),(c,l,o)] = limb_l( +-g[r,c,(o-m)%N] ), sign applied in u32
    before the limb split.  Column layout (c, limb, o) matches ``ep_combine``.
    ``key_limbs=3`` zeroes limb 0 (the truncated-key mode of the whole-scan
    kernels: the low byte of each sign-twisted word is dropped).
    """
    if key_limbs not in (3, NUM_LIMBS):
        raise ValueError(f"key_limbs is 4 (exact) or 3 (truncated), got {key_limbs}")
    return _toeplitz_to_w(sign_toeplitz_u32(bk_u32), key_limbs)


def bk_to_matmul_w_cols(bk_u32, o_start, n_cols: int,
                        key_limbs: int = NUM_LIMBS) -> torch.Tensor:
    """Column-sliced Toeplitz weights int8[R*N(m), C*4*n_cols(o)]: the local
    shard of ``bk_to_matmul_w`` for output coefficients [o_start,
    o_start+n_cols).  Needs the full key rows (every output coefficient
    touches every input coefficient of g)."""
    return _toeplitz_to_w(sign_toeplitz_u32_cols(bk_u32, o_start, n_cols), key_limbs)


def _toeplitz_to_w(t, key_limbs: int = NUM_LIMBS) -> torch.Tensor:
    """Sign-twisted u32 [R, C, m, cols] -> limb weights int8[R*m, C*4*cols]."""
    limbs = to_signed_limbs(t)  # [R, C, m, cols, L]
    if key_limbs == 3:
        limbs[..., 0] = 0
    limbs = limbs.movedim(-1, -2).transpose(1, 2)  # [R, m, C, L, cols]
    r, n = limbs.shape[:2]
    return limbs.reshape(r * n, -1)


#: output coefficients of the Toeplitz expansion ``ep_contract_matmul``
#: builds at once above this degree
EP_MATMUL_COLS = 256


def ep_contract_matmul(digits_i8, bk_u32, key_limbs: int = NUM_LIMBS) -> torch.Tensor:
    """Exact external-product contraction: digits int8[B, R, N] x GGSW
    u32[R, C, N] -> int32[B, C*4, N] limb accumulators,
    out[b,(c,l),o] = sum_{r,m} digits[b,r,m] * limb_l(+-g[r,c,(o-m)%N])
    (limb 0 taken as 0 when ``key_limbs=3``).

    The Toeplitz expansion is built per call and shared across the batch;
    above ``EP_MATMUL_COLS`` coefficients it is built that many output
    coefficients at a time, which bounds its copies (whole, they take
    ~8 GB at N=4096).
    """
    n, c = bk_u32.shape[-1], bk_u32.shape[1]
    if n <= EP_MATMUL_COLS:
        return _contract_w(digits_i8, bk_to_matmul_w(bk_u32, key_limbs), c)
    return torch.cat([_contract_w(digits_i8, bk_to_matmul_w_cols(bk_u32, o, EP_MATMUL_COLS,
                                                                  key_limbs), c)
                      for o in range(0, n, EP_MATMUL_COLS)], dim=-1)


def ep_contract_matmul_cols(digits_i8, bk_u32, o_start, n_cols: int) -> torch.Tensor:
    """Coefficient shard of ``ep_contract_matmul``: int32[B, C*4, n_cols]
    limb accumulators for output coefficients [o_start, o_start+n_cols)."""
    return _contract_w(digits_i8, bk_to_matmul_w_cols(bk_u32, o_start, n_cols),
                       bk_u32.shape[1])


def _contract_w(digits_i8, w, c: int) -> torch.Tensor:
    """digits int8[B, R, N] x W int8[R*N, C*4*cols] -> int32[B, C*4, cols],
    one column block at a time to bound the float64 copy."""
    b = digits_i8.shape[0]
    w = w.view(w.shape[0], c, -1)
    flat = digits_i8.reshape(b, w.shape[0])
    acc = torch.stack([int_matmul(flat, w[:, j]) for j in range(c)], dim=1)
    return acc.reshape(b, c * NUM_LIMBS, -1)


def ep_combine(acc_i32, k_plus_1: int) -> torch.Tensor:
    """int32[B, C*4, N] limb accumulators -> u32[B, C, N] wrapping GLWE delta."""
    b, _, n = acc_i32.shape
    accs = acc_i32.reshape(b, k_plus_1, NUM_LIMBS, n).movedim(-2, -1)
    return combine_limb_accs(accs)


def ep_combine_planes(acc_i32) -> torch.Tensor:
    """int32[C, L, B, N] limb planes -> u32[C, B, N] wrapping delta."""
    return combine_limb_accs(acc_i32.movedim(1, -1))


def level_major_row_perm(k_plus_1: int, levels: int) -> np.ndarray:
    """Permutation mapping level-major row r' = level*(k+1)+poly to the
    canonical GGSW row poly*levels+level (src/ggsw.rs:43-75 layout)."""
    rp = np.arange(k_plus_1 * levels)
    return (rp % k_plus_1) * levels + (rp // k_plus_1)
