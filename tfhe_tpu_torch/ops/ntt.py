"""Negacyclic block-NTT tier (port of ``tfhe_tpu/ops/ntt.py``).

Exact products in Z_{2^32}[X]/(X^N+1) (reference semantics
src/utils.rs:155-160) through a hybrid block-NTT:

  Z[X]/(X^N + 1)  with  N = N1 * N2,  Z := X^{N2}
    = polynomials sum_{j<N2} X^j * A_j(Z)   with   A_j in Z[Z]/(Z^{N1}+1)

  * the inner ring Z[Z]/(Z^{N1}+1) goes through a size-N1 negacyclic NTT
    (the psi-twist folded into an [N1, N1] matrix) modulo two CRT primes
    p1=12289, p2=40961 (both = 1 mod 2*N1 for N1 | 2048);
  * the outer length-N2 convolution (a twisted circulant: a Z-twist on
    wraparound) is merged with TFHE's row contraction into one product per
    NTT bin:

        C_hat[bin, b, (c,lam,j_out)] =
            sum_{(r,j1)} D_hat[bin, b, (r,j1)] * K_hat[bin, (r,j1), (c,lam,j_out)]

All arithmetic is integer and every result is bit-identical to the Toeplitz
backends.  Residues mod p (p < 2^16) ride in two balanced int8 limbs (base
256), every product is int8 x int8 with bounded accumulation (run through
``torus.int_matmul``, exact in float64: every sum here stays below 2^26), and
each limb plane is reduced mod p (floor-mod on int32) before the planes are
shift-combined.  The key side is split into balanced base-2^kb limbs, with kb
chosen per plan so the true integer convolution stays below P/2 = p1*p2/2;
each limb's convolution is recovered exactly by a centered CRT lift and the
limbs are recombined with wrapping u32 shifts.

u32 values are int32 tensors (see ``ops/torus.py``).  The JAX module's dense
[N, N] transform tables (``_dense_fwd_np``/``_dense_inv_np``) are not ported:
they exist only because Mosaic cannot realise the strided split
c = i*N2 + j1 inside a TPU kernel.  The CUDA kernel (``csrc/ntt_kernel.cu``)
indexes that split directly and runs the [N1, N1] transform per column.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from tfhe_tpu_torch.ops.torus import int_matmul, to_signed_limbs, u32

#: CRT primes: p = 1 (mod 2*N1) for every power-of-two N1 <= 2048, and
#: p < 2^16 so centered residues fit two balanced int8 limbs.
PRIMES = (12289, 40961)
#: product of PRIMES; exact lifts need |true integer coeff| < P_CRT / 2
P_CRT = PRIMES[0] * PRIMES[1]


@dataclass(frozen=True)
class NttPlan:
    """Static shape/limb plan for one (N, rows, max_digit) workload.

    ``rows`` is the contraction row count R (digit polynomials), ``max_digit``
    the digit magnitude bound (16 for the base-16 gadget: digits lie in
    [-8,7] union {+16}, the reference's carry anomaly, src/decomposer.rs:42-80).
    ``key_bits``/``key_limbs`` define the balanced key split, chosen so that
    R * N * max_digit * 2^(key_bits-1) < P_CRT/2.
    """

    n: int  # polynomial degree N
    n1: int  # inner (NTT) size
    key_bits: int
    key_limbs: int
    max_digit: int

    @property
    def n2(self) -> int:
        return self.n // self.n1

    def __post_init__(self):
        assert self.n % self.n1 == 0
        assert self.n1 & (self.n1 - 1) == 0 and self.n1 <= 2048
        assert self.key_bits * self.key_limbs >= 32


#: sweep hook: force the inner NTT size for every plan consumer in this
#: process.  None = the make_plan default.
_N1_OVERRIDE: int | None = None


def set_plan_n1(n1: int | None) -> None:
    """Force plan N1 process-wide (None restores the default).  The caller
    must rebuild any NTT-domain keys afterwards: layouts change shape."""
    global _N1_OVERRIDE
    _N1_OVERRIDE = n1


def plan_for_params(params) -> NttPlan:
    """The PBS external-product plan for a parameter set: R = (k+1)*levels
    digit rows with |digit| <= B = 2^log_base (the +B carry anomaly included,
    src/decomposer.rs:42-80)."""
    dp = params.pbs_decomposer
    rows = (params.glwe_dimension + 1) * dp.levels
    return make_plan(params.degree, rows=rows, max_digit=1 << dp.log_base, n1=_N1_OVERRIDE)


def make_plan(n: int, rows: int, max_digit: int = 16, n1: int | None = None) -> NttPlan:
    """Pick the inner size and key-limb split for an R-row contraction at
    degree N.  N1 defaults to 64, doubled while the merged per-bin product's
    int8 accumulation bound R*N2 * 128^2 <= 2^30 fails."""
    if n1 is None:
        n1 = 64
        while n1 < n and (n // n1) * rows * (1 << 14) > (1 << 30):
            n1 *= 2
        n1 = min(n1, n, 2048)
    # balanced key limbs: R*N*max_digit*2^(kb-1) < P/2, top limb included
    kb = 1
    while rows * n * max_digit * (1 << kb) < P_CRT // 2 and kb < 16:
        kb += 1
    assert kb >= 2, "contraction too large for the 2-prime CRT range"
    limbs = -(-32 // kb)
    return NttPlan(n=n, n1=n1, key_bits=kb, key_limbs=limbs, max_digit=max_digit)


def _find_psi(p: int, order: int) -> int:
    """Smallest primitive ``order``-th root of unity mod p (order | p-1)."""
    assert (p - 1) % order == 0
    for g in range(2, p):
        c = pow(g, (p - 1) // order, p)
        if pow(c, order // 2, p) != 1:
            return c
    raise ValueError("no root found")


def _center_np(x, p):
    x = x % p
    return np.where(x > p // 2, x - p, x)


@functools.lru_cache(maxsize=None)
def _tables(n1: int):
    """Per-prime numpy tables for the size-N1 negacyclic NTT (a copy of the
    JAX module's).  Returns, per prime, a dict with

      w_fwd  int32[N1, N1]: W[i, bin] = psi^{i(2bin+1)} mod p (centered)
      w_inv  int32[N1, N1]: W[bin, i] = psi^{-i(2bin+1)} / N1 mod p (centered)
      zhat   int32[N1]:     NTT eigenvalues of Z (= psi^{2bin+1}) mod p, in [0, p)
    """
    out = []
    for p in PRIMES:
        psi = _find_psi(p, 2 * n1)
        i = np.arange(n1, dtype=np.int64)[:, None]
        b = np.arange(n1, dtype=np.int64)[None, :]
        psi_pow = np.array([pow(psi, e, p) for e in range(2 * n1)], np.int64)
        w_fwd = psi_pow[(i * (2 * b + 1)) % (2 * n1)]
        psi_inv = pow(psi, 2 * n1 - 1, p)
        psi_inv_pow = np.array([pow(psi_inv, e, p) for e in range(2 * n1)], np.int64)
        n1_inv = pow(n1, p - 2, p)
        w_inv = (psi_inv_pow[(b * (2 * i + 1)) % (2 * n1)] * n1_inv) % p
        zhat = psi_pow[(2 * np.arange(n1, dtype=np.int64) + 1) % (2 * n1)]
        out.append(dict(w_fwd=_center_np(w_fwd, p).astype(np.int32),
                        w_inv=_center_np(w_inv, p).astype(np.int32),
                        zhat=zhat.astype(np.int32)))
    return out


@functools.lru_cache(maxsize=None)
def _table(n1: int, prime_index: int, name: str, device: torch.device) -> torch.Tensor:
    """One of ``_tables`` as a tensor on ``device``, copied there once."""
    return torch.from_numpy(_tables(n1)[prime_index][name]).to(device)


# ---------------------------------------------------------------------------
# modular / limb helpers
# ---------------------------------------------------------------------------


def mod_center(x: torch.Tensor, p: int) -> torch.Tensor:
    """Integer tensor -> centered residue in [-(p//2), p//2] (exact), same dtype."""
    r = torch.remainder(x, p)  # floor-mod: [0, p)
    return r - p * (r > p // 2).to(r.dtype)


def split2_i8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Centered int (|x| <= 2^14.4) -> (hi, lo) int8 with x = hi*256 + lo,
    lo in [-128, 128)."""
    lo = ((x + 128) & 255) - 128
    hi = (x - lo) >> 8
    return hi.to(torch.int8), lo.to(torch.int8)


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def key_limbs_i32(g_u32, key_bits: int, key_limbs: int) -> torch.Tensor:
    """u32[...] -> int32[key_limbs, ...] balanced base-2^key_bits limbs of the
    signed value: sum(limb_l << (key_bits*l)) == g (mod 2^32),
    |limb| <= 2^(kb-1).  The int32 arithmetic wraps as the JAX module's does."""
    v = u32(g_u32).to(torch.int64)  # the mod-2^32 signed view
    half = 1 << (key_bits - 1)
    mask = (1 << key_bits) - 1
    limbs = []
    for _ in range(key_limbs - 1):
        lo = ((v + half) & mask) - half
        limbs.append(lo)
        v = _wrap_i32(v - lo).to(torch.int64) >> key_bits
    limbs.append(v)
    return torch.stack(limbs).to(torch.int32)


def _matmul_i8_planes(lhs_hi, lhs_lo, rhs_hi, rhs_lo):
    """Raw limb-plane products of (a_hi*256+a_lo) @ (b_hi*256+b_lo), batched
    ``torch.matmul`` orientation: returns the (hh, hl+lh, ll) int32 planes
    without modular combination.  The planes are linear in the contraction,
    so partial-contraction planes may be summed (over a sharded bin axis)
    before ``_combine_planes``."""
    return (int_matmul(lhs_hi, rhs_hi),
            int_matmul(lhs_hi, rhs_lo) + int_matmul(lhs_lo, rhs_hi),
            int_matmul(lhs_lo, rhs_lo))


def _combine_planes(hh, m, ll, p: int) -> torch.Tensor:
    """(hh*256 + m)*256 + ll mod p, centered; each plane is reduced mod p
    before the shift-combine so every intermediate stays below 2^24."""
    x = mod_center((mod_center(hh, p) << 8) + mod_center(m, p), p)
    return mod_center((x << 8) + mod_center(ll, p), p)


def _matmul_i8_mod(lhs_hi, lhs_lo, rhs_hi, rhs_lo, p: int) -> torch.Tensor:
    """Exact (a_hi*256+a_lo) @ (b_hi*256+b_lo) mod p, centered, via four int8
    plane products."""
    return _combine_planes(*_matmul_i8_planes(lhs_hi, lhs_lo, rhs_hi, rhs_lo), p)


# ---------------------------------------------------------------------------
# key preparation (key-load time)
# ---------------------------------------------------------------------------


def make_ep_ntt_key(bk_u32, plan: NttPlan) -> torch.Tensor:
    """GGSW key u32[..., R, C, N] -> merged per-bin operand
    int8[..., P, 2(hi/lo), N1(bin), R*N2, C*key_limbs*N2].

    Per NTT bin it encodes the twisted-circulant block matrix
      K[(r,j1), (c,lam,j_out)] = NTT(G_lam[r,c, (j_out-j1) mod N2])[bin]
                                 * (zhat[bin] if j_out < j1 else 1)
    where G_j2(Z) gathers every N2-th coefficient of g (g[j2 + N2*i]) and
    lam indexes the balanced key limbs.  The Z-twist is applied to the N2
    transformed limbs before the N2 x N2 gather, and the gather runs on
    int16 residues, so the workspace stays near twice the int8 output."""
    n1, n2, n = plan.n1, plan.n2, plan.n
    bk = u32(bk_u32)
    *lead, r_dim, c_dim, n_ = bk.shape
    assert n_ == n
    dev = bk.device
    glimbs = key_limbs_i32(bk, plan.key_bits, plan.key_limbs)  # [L, ..., R, C, N]
    g = glimbs.movedim(0, -2)  # [..., R, C, L, N]
    g = g.reshape(g.shape[:-1] + (n1, n2)).transpose(-1, -2)  # [..., R, C, L, N2(j2), N1(i)]
    # (j1, jout) -> index into [unwrapped | Z-twisted] x j2
    j1 = torch.arange(n2, device=dev)[:, None]
    jout = torch.arange(n2, device=dev)[None, :]
    pick = ((jout < j1).long() * n2 + torch.remainder(jout - j1, n2)).reshape(-1)
    out = torch.empty((*lead, len(PRIMES), 2, n1, r_dim * n2, c_dim * plan.key_limbs * n2),
                      dtype=torch.int8, device=dev)
    for pi, p in enumerate(PRIMES):
        g_hi, g_lo = split2_i8(mod_center(g, p))
        w_hi, w_lo = split2_i8(_table(n1, pi, "w_fwd", dev))  # [N1(i), N1(bin)]
        ghat = _matmul_i8_mod(g_hi, g_lo, w_hi, w_lo, p)  # [..., R, C, L, j2, bin]
        zhat = _table(n1, pi, "zhat", dev).to(torch.int64)
        twisted = mod_center(ghat.to(torch.int64) * zhat, p).to(torch.int32)
        both = torch.cat([ghat, twisted], dim=-2).to(torch.int16)  # |x| <= p/2 < 2^15
        sel = both.index_select(-2, pick)  # [..., R, C, L, N2*N2, bin]
        sel = sel.reshape(sel.shape[:-2] + (n2, n2, n1))  # [..., R, C, L, j1, jout, bin]
        # -> [..., bin, R, j1, C, L, jout], written straight into the output
        order = (*range(nl := len(lead)), nl + 5, nl, nl + 3, nl + 1, nl + 2, nl + 4)
        shape = (*lead, n1, r_dim, n2, c_dim, plan.key_limbs, n2)
        for half, plane in enumerate(split2_i8(sel)):
            out[..., pi, half, :, :, :].view(shape).copy_(plane.permute(order))
    return out


def ntt_key_lhs_form(bk_ntt: torch.Tensor) -> torch.Tensor:
    """``make_ep_ntt_key`` output [..., P, 2(klimb), bins, RN2, CLN2] ->
    lhs form int8[..., P, bins, 2*CLN2, RN2] (key-limb blocks stacked on rows,
    contraction transposed): the operand of the fused kernel."""
    x = bk_ntt.transpose(-1, -2).movedim(-4, -3)  # [..., P, bins, 2, CLN2, RN2]
    return x.reshape(x.shape[:-3] + (2 * x.shape[-2], x.shape[-1])).contiguous()


def ntt_key_rhs_form(bk_lhs: torch.Tensor) -> torch.Tensor:
    """The inverse of ``ntt_key_lhs_form``: [..., P, bins, 2*CLN2, RN2] ->
    [..., P, 2, bins, RN2, CLN2]."""
    x = bk_lhs.reshape(bk_lhs.shape[:-2] + (2, bk_lhs.shape[-2] // 2, bk_lhs.shape[-1]))
    return x.movedim(-3, -4).transpose(-1, -2)


# ---------------------------------------------------------------------------
# the contraction (per blind-rotation step)
# ---------------------------------------------------------------------------


def ntt_fwd_digits_cols(digits_i8, plan: NttPlan, bin_start: int = 0,
                        bins_local: int | None = None):
    """int8[B, R, N] digits -> per prime, (hi, lo) int8[bins, B, R*N2] of
    the forward NTT restricted to bins [bin_start, bin_start+bins_local)."""
    b, r_dim, _ = digits_i8.shape
    n1, n2 = plan.n1, plan.n2
    bins_local = n1 if bins_local is None else bins_local
    # out[bin, b, r, j1] = sum_i w[i, bin] * d[b, r, i, j1]
    d = digits_i8.reshape(b, r_dim, n1, n2).permute(2, 0, 1, 3).reshape(n1, b * r_dim * n2)
    outs = []
    for pi, p in enumerate(PRIMES):
        w = _table(n1, pi, "w_fwd", digits_i8.device)[:, bin_start:bin_start + bins_local]
        w_hi, w_lo = split2_i8(w.transpose(0, 1))  # [bin, i]
        hi = mod_center(int_matmul(w_hi, d), p)
        lo = mod_center(int_matmul(w_lo, d), p)
        dh = mod_center((hi << 8) + lo, p)  # [bin, B*R*N2]
        outs.append(split2_i8(dh.reshape(bins_local, b, r_dim * n2)))
    return outs


def ntt_fwd_digits(digits_i8, plan: NttPlan):
    """int8[B, R, N] digits -> per prime, (hi, lo) int8[N1(bin), B, R*N2]."""
    return ntt_fwd_digits_cols(digits_i8, plan)


def _contract_planes(dhats, bk_ntt_bins, plan: NttPlan, bin_start: int, bins_local: int):
    """Per prime: the merged per-bin product (reduced mod p) and the raw
    inverse-NTT limb planes over the given bins, each [3, B, CLN2, N1]."""
    per_prime = []
    for pi, p in enumerate(PRIMES):
        d_hi, d_lo = dhats[pi]  # [bins, B, RN2]
        # [bins, B, RN2] @ [bins, RN2, CLN2] -> [bins, B, CLN2]
        chat = _matmul_i8_mod(d_hi, d_lo, bk_ntt_bins[pi, 0], bk_ntt_bins[pi, 1], p)
        w_inv = _table(plan.n1, pi, "w_inv", chat.device)[bin_start:bin_start + bins_local]
        c_hi, c_lo = split2_i8(chat.permute(1, 2, 0))  # [B, CLN2, bins]
        wi_hi, wi_lo = split2_i8(w_inv)  # [bins, i]
        per_prime.append(torch.stack(_matmul_i8_planes(c_hi, c_lo, wi_hi, wi_lo)))
    return per_prime


def ep_contract_ntt(digits_i8, bk_ntt_step, plan: NttPlan, c_dim: int) -> torch.Tensor:
    """The NTT-domain external-product contraction: digits int8[B, R, N],
    bk_ntt_step int8[P, 2, N1, R*N2, C*L*N2] (one step of ``make_ep_ntt_key``)
    -> u32[B, C, N] wrapping delta."""
    planes = _contract_planes(ntt_fwd_digits(digits_i8, plan), bk_ntt_step, plan, 0, plan.n1)
    return ep_finish_ntt(torch.stack(planes), plan, c_dim)


def _crt_lift_combine(res, plan: NttPlan, c_dim: int, b: int) -> torch.Tensor:
    """Per-prime centered INTT residues [B, C*L*N2, N1] -> u32[B, C, N]:
    centered CRT lift, limb recombination, coefficient reorder."""
    n1, n2, L = plan.n1, plan.n2, plan.key_limbs
    p1, p2 = PRIMES
    inv_p1 = pow(p1, p2 - 2, p2)
    t2 = mod_center((res[1] - res[0]) * inv_p1, p2)
    s = res[0] + p1 * t2  # |S| < P/2 < 2^31: exact int32
    s = s.reshape(b, c_dim, L, n2, n1).transpose(-1, -2)  # [B, C, L, N1(i), N2(jout)]
    s = s.reshape(b, c_dim, L, plan.n)
    out = s[:, :, 0]
    for lam in range(1, L):
        out = out + (s[:, :, lam] << (plan.key_bits * lam))
    return out


# ---------------------------------------------------------------------------
# bin-sharded contraction: each shard owns a contiguous slice of the N1 NTT
# bins (forward NTT, merged product and partial INTT are local); only the raw
# int32 INTT limb planes are summed across shards, after which the modular
# combine and CRT lift run once.  Bit-exact vs the single-device contraction.
# ---------------------------------------------------------------------------


def ep_contract_ntt_partial(digits_i8, bk_ntt_local, plan: NttPlan, c_dim: int,
                            bin_start: int, bins_local: int) -> torch.Tensor:
    """Local-bin partial contraction: int32[P, 3, B, C*L*N2, N1] raw INTT limb
    planes (hh, hl+lh, ll per prime), linear in the bin axis: sum them
    across shards, then ``ep_finish_ntt``.  ``bk_ntt_local`` is the local bin
    slice of ``make_ep_ntt_key``'s output: int8[P, 2, bins_local, RN2, CLN2]."""
    dhats = ntt_fwd_digits_cols(digits_i8, plan, bin_start, bins_local)
    return torch.stack(_contract_planes(dhats, bk_ntt_local, plan, bin_start, bins_local))


def ep_finish_ntt(planes, plan: NttPlan, c_dim: int) -> torch.Tensor:
    """Combine (summed) raw INTT limb planes [P, 3, B, CLN2, N1] -> u32[B, C, N].
    Each raw plane entry is a sum of <= N1 (<= 2048) int8*int8 products
    (< 2^25), so the planes stay int32-safe over the full bin range."""
    res = [_combine_planes(planes[pi, 0], planes[pi, 1], planes[pi, 2], p)
           for pi, p in enumerate(PRIMES)]
    return _crt_lift_combine(res, plan, c_dim, planes.shape[2])


# ---------------------------------------------------------------------------
# general negacyclic product (API parity with src/utils.rs:155-160)
# ---------------------------------------------------------------------------


def poly_mul_ntt(a_u32, b_u32) -> torch.Tensor:
    """Exact u32 negacyclic product via the block-NTT (general operands).

    a's 4 balanced base-256 limbs act as the small "digit" rows (|limb| <=
    128) against a key of shifted copies of b (g_r = b << 8r mod 2^32):
    sum_r conv(a_r, b<<8r) == conv(a, b) mod 2^32."""
    a, bq = u32(a_u32), u32(b_u32)
    assert a.shape == bq.shape
    lead, n = a.shape[:-1], a.shape[-1]
    a2, b2 = a.reshape(-1, n), bq.reshape(-1, n)
    plan = make_plan(n, rows=4, max_digit=128)
    digits = to_signed_limbs(a2).movedim(-1, 1)  # int8[B, 4, N]
    key = torch.stack([b2 << (8 * r) for r in range(4)], dim=1)[:, :, None, :]  # [B, 4, 1, N]
    bk_ntt = make_ep_ntt_key(key, plan)  # [B, P, 2, bin, 4*N2, L*N2]
    out = torch.stack([ep_contract_ntt(digits[i:i + 1], bk_ntt[i], plan, c_dim=1)[0, 0]
                       for i in range(a2.shape[0])])
    return out.reshape(lead + (n,))
