"""Kernel C's tensor-core step (``tfhe_tpu_torch/csrc/latency_kernel.cu``),
replayed on the CPU register by register, against one step of its twin
``blind_rotate_latency_ref``.

The replay follows the kernel's indexing: the plan's derived sizes
(``derive``); each CTA's block of digit words for its own coefficients and
the exchange of the digit groups each CTA's k-chunks touch into its
``ext``; each consumer warp's n-tile block and k-split of the CTA's
k-chunks, walked in segments within one digit group; the A registers read
from the key operand's words as stored; the B registers read from the digit
word of offset (j0 + gid - t0 - tig) mod 2N through the window that rotates
through fixed registers; the mma.sync m16n8k32 fragment layouts of the PTX
ISA (A row-major, B column-major, C); the limb recombination across lanes
4 and 8 apart and its store by the lanes of each limb; and the sum of the
CTAs' partial deltas at each owner mod 2^32.  Every comparison is
bit-exact; each product is also checked to stay inside int32.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tfhe_tpu_torch.ops.cuda import latency_kernel as latk
from tfhe_tpu_torch.ops.torus import to_numpy_u32, to_torch_u32
from tfhe_tpu_torch.params import get_params

WARPS = 8  # consumer warps (latency_kernel.cu:kWarps)
MAX_NTW = 8


def derive(n, c, v, levels, cs):
    """The plan's derived sizes, as ``latency_kernel.cu:derive`` makes them;
    None where the cluster's CTAs cannot split the key columns evenly or a
    CTA's coefficients do not fill whole n-tiles."""
    g = -(-v * c * levels // 4)
    nj, chunks = n // cs, g * n // 8
    if nj < 8 or chunks % cs:
        return None
    tiles = n // 8
    ntw = min(max(tiles // WARPS, 1), MAX_NTW)
    blocks = tiles // ntw
    return dict(G=g, R4=4 * c, nj=nj, cpc=chunks // cs, ntw=ntw,
                ks=WARPS // blocks if blocks < WARPS else 1,
                bpw=1 if blocks < WARPS else blocks // WARPS)


def sent_block(p, acc, a_v, g_tot, rank, nj):
    """The digit phase of CTA ``rank``: its outgoing block of digit words,
    bytes [2 signs, G, nj words, 4], for the sample's accumulator acc u32
    [C, N] and exponents a_v [V].  Job (v, poly, jl) takes coefficient
    i = rank*nj + jl, reads rot's acc[poly, i - a] (from the CTA that holds
    it) and stores digit l of (rot - acc)[poly, i], row
    v*R + poly*levels + (levels-1-l), at byte row%4 of word (row//4, jl) of
    sign 0, and its negation in sign 1; bytes of rows past V*R stay 0."""
    dp = p.pbs_decomposer
    c, n = acc.shape
    lb, ig, levels = dp.log_base, dp.ignored_bits, dp.levels
    flat = np.zeros(2 * g_tot * nj * 4, np.uint8)
    jl = np.arange(nj)
    i = rank * nj + jl
    for v in range(a_v.shape[0]):
        a = int(a_v[v]) & (2 * n - 1)
        for poly in range(c):
            src = (i - a) & (2 * n - 1)
            sn = src & (n - 1)
            owner, at = sn // nj, sn % nj  # the CTA holding acc[poly, sn], and where
            rot = acc[poly][owner * nj + at].astype(np.uint64)
            rot = np.where(src >= n, (1 << 32) - rot, rot) % (1 << 32)
            diff = (rot - acc[poly, i].astype(np.uint64)) % (1 << 32)
            val = ((diff >> ig) + ((diff >> (ig - 1)) & 1)) if ig else diff
            carry = np.zeros(nj, np.int64)
            for l in range(levels):
                res = ((val >> (lb * l)) & ((1 << lb) - 1)).astype(np.int64) + carry
                cm = res & (1 << (lb - 1))
                res = res - 2 * cm  # in [-B/2, B]: the +B anomaly stays
                carry = cm >> (lb - 1)
                row = v * c * levels + poly * levels + levels - 1 - l
                off = ((row // 4) * nj + jl) * 4 + row % 4
                flat[off] = res.astype(np.int8).view(np.uint8)
                flat[off + 4 * g_tot * nj] = (-res).astype(np.int8).view(np.uint8)
    return flat.reshape(2, g_tot, nj, 4)


def words(b4):
    """uint8 [..., 4] -> the little-endian 32-bit words [...]."""
    return np.ascontiguousarray(b4).view(np.uint32)[..., 0]


def signed_bytes(w):
    """32-bit words [...] -> their four int8 bytes [..., 4], byte 0 first."""
    return np.ascontiguousarray(w, dtype=np.uint32)[..., None].view(np.uint8).view(np.int8)


_LANE = np.arange(32)
_GID, _TIG = _LANE // 4, _LANE % 4
# where each A element (row, k) and B element (k, n) of mma.sync m16n8k32 .s8
# sits: (lane, register, byte), and which D elements c0..c3 of each lane hold
_ROW, _K = np.meshgrid(np.arange(16), np.arange(32), indexing="ij")
A_AT = ((_ROW % 8) * 4 + (_K % 16) // 4, (_ROW >= 8) + 2 * (_K >= 16), _K % 4)
_KB, _NB = np.meshgrid(np.arange(32), np.arange(8), indexing="ij")
B_AT = (_NB * 4 + (_KB % 16) // 4, (_KB >= 16).astype(int), _KB % 4)
C_ROWS = np.stack([_GID, _GID, _GID + 8, _GID + 8], axis=1)
C_COLS = np.stack([2 * _TIG, 2 * _TIG + 1, 2 * _TIG, 2 * _TIG + 1], axis=1)


def mma_m16n8k32(a_regs, b_regs):
    """D = A B of mma.sync.m16n8k32.row.col.s32.s8.s8.s32 from the registers
    of its 32 lanes (PTX ISA fragment layouts), for a stack of n-tiles:
    a_regs u32 [32, 4], b_regs u32 [T, 32, 2] -> c int64 [T, 32, 4] (lane
    gid*4 + tig: c0, c1 at row gid, columns 2tig, 2tig+1; c2, c3 at row
    gid+8).  A element (row, k): lane (row mod 8)*4 + (k mod 16)//4,
    register (row >= 8) + 2*(k >= 16), byte k mod 4; B element (k, n): lane
    n*4 + (k mod 16)//4, register k >= 16, byte k mod 4."""
    a = signed_bytes(a_regs).astype(np.int64)[A_AT]  # [16, 32]
    b = signed_bytes(b_regs).astype(np.int64)[:, B_AT[0], B_AT[1], B_AT[2]]  # [T, 32, 8]
    d = a @ b  # [T, 16, 8]
    return d[:, C_ROWS, C_COLS]


def kernel_c_step(p, acc, bk_step, a_v, cs):
    """One step of the kernel on one sample's cluster of cs CTAs: acc u32
    [C, N], the step's key operand int8 [C*4, 4*G*N], exponents [V] -> the
    new accumulator u32 [C, N]."""
    c, n = acc.shape
    sh = derive(n, c, a_v.shape[0], p.pbs_decomposer.levels, cs)
    assert sh is not None
    g_tot, r4, nj, cpc, ntw, ks = (sh[k] for k in ("G", "R4", "nj", "cpc", "ntw", "ks"))
    assert bk_step.shape == (r4, 4 * g_tot * n)
    # the exchange: CTA o's block [2 signs][G][nj] words, of which CTA r
    # receives the digit groups its k-chunks touch at its ext[sign][o][g - glo]
    blocks = [words(sent_block(p, acc, a_v, g_tot, o, nj)) for o in range(cs)]
    glo = [r * cpc // (n // 8) for r in range(cs)]
    ghi = [((r + 1) * cpc - 1) // (n // 8) for r in range(cs)]
    gd = max(h - lo + 1 for lo, h in zip(glo, ghi))
    exts = np.zeros((cs, 2, cs, gd, nj), np.uint32)
    for r in range(cs):
        for o in range(cs):
            exts[r, :, o, :ghi[r] - glo[r] + 1] = blocks[o][:, glo[r]:ghi[r] + 1]
    gdnj = gd * nj
    key = words(bk_step.numpy().view(np.uint8).reshape(r4, g_tot * n, 4))  # u32 [R4, G*N]
    lane, gid, tig = _LANE, _GID, _TIG
    mask2, lgnj, cpg, kw = 2 * n - 1, nj.bit_length() - 1, n // 8, 8 * cpc
    # recv[owner][sender][C][nj]: each CTA's partials of each owner's coefficients
    recv = np.zeros((cs, cs, c, nj), np.uint64)
    for rank in range(cs):
        ext = exts[rank].reshape(-1)
        stage = key[:, rank * kw:(rank + 1) * kw]  # the CTA's k-chunks of the step
        part = np.zeros((ks, cs, c, nj), np.uint64)
        for warp in range(WARPS):
            kq = warp % ks
            q_lo, q_hi = kq * cpc // ks, (kq + 1) * cpc // ks
            for k in range(sh["bpw"]):
                blk = warp // ks + k * (WARPS // ks)
                j0 = blk * ntw * 8
                jd = j0 + gid - tig
                acc_c = np.zeros((ntw, 32, 4), np.int64)
                zero = np.zeros(32, np.uint32)
                lo_row, hi_row = np.minimum(gid, r4 - 1), np.minimum(gid + 8, r4 - 1)

                def a_regs(q):  # the A registers of the CTA's k-chunk q
                    lc = 8 * q
                    return np.stack([
                        np.where(gid < r4, stage[lo_row, lc + tig], zero),
                        np.where(gid + 8 < r4, stage[hi_row, lc + tig], zero),
                        np.where(gid < r4, stage[lo_row, lc + 4 + tig], zero),
                        np.where(gid + 8 < r4, stage[hi_row, lc + 4 + tig], zero)], axis=1)

                def mma(q, b0_b1):  # the NTW mma of k-chunk q; b0_b1: (b0, b1) per n-tile
                    b_regs = np.stack([np.stack(pair, axis=1) for pair in b0_b1])
                    return mma_m16n8k32(a_regs(q), b_regs)

                qa, mw = q_lo, 2 * ntw - 1
                while qa < q_hi:  # segments of k-chunks within one digit group
                    g = (rank * cpc + qa) // cpg
                    qb = min(q_hi, (g + 1) * cpg - rank * cpc)
                    t0a = (rank * cpc + qa - g * cpg) * 8

                    def word(m, g=g):  # ext[m // nj] of group g, at m mod nj
                        m &= mask2
                        return ext[(m >> lgnj) * gdnj + (g - glo[rank]) * nj + (m & (nj - 1))]

                    # v[(2n - 2u) mod 2NTW], v[... + 1] hold b0, b1 of n-tile
                    # n of the u-th k-chunk of a run of NTW; the remainder
                    # shifts v itself
                    v = []
                    for nn in range(ntw):
                        v += [word(jd - t0a + 8 * nn), word(jd - t0a - 4 + 8 * nn)]
                    q = qa
                    while q + ntw <= qb:
                        for u in range(ntw):
                            ks_ = [(2 * nn - 2 * u) & mw for nn in range(ntw)]
                            acc_c += mma(q + u, [(v[k], v[k + 1]) for k in ks_])
                            t0 = t0a + 8 * (q + u + 1 - qa)
                            k = (-2 * u - 2) & mw
                            v[k], v[k + 1] = word(jd - t0), word(jd - t0 - 4)
                        q += ntw
                    while q < qb:
                        acc_c += mma(q, [(v[2 * nn], v[2 * nn + 1]) for nn in range(ntw)])
                        t0 = t0a + 8 * (q + 1 - qa)
                        v = [word(jd - t0), word(jd - t0 - 4)] + v[:-2]
                        q += 1
                    qa = qb
                assert np.abs(acc_c).max() < 2**31  # the s32 sums never wrap
                # the shuffles: x[n][r] summed over the lanes 4 and 8 apart
                shift = (8 * (gid % 4)).astype(np.uint64)[None, :, None]
                x = ((acc_c % (1 << 32)).astype(np.uint64) << shift) % (1 << 32)
                x = (x + x[:, lane ^ 4]) % (1 << 32)
                x = (x + x[:, lane ^ 8]) % (1 << 32)
                # lane (gid, tig) of limb l = gid % 4 stores its c_l register:
                # column 2*(l // 2) + gid // 4, output j0 + 8n + 2 tig + l % 2
                l_of = gid % 4
                col = 2 * (l_of >> 1) + gid // 4
                for ln in np.flatnonzero(col < c):
                    for nn in range(ntw):
                        j = j0 + 8 * nn + 2 * tig[ln] + (l_of[ln] & 1)
                        part[kq, j // nj, col[ln], j % nj] = x[nn, ln, l_of[ln]]
        recv[:, rank] = part.sum(0) % (1 << 32)  # the k-splits summed, sent to each owner
    new = acc.astype(np.uint64).copy()
    for owner in range(cs):
        new[:, owner * nj:(owner + 1) * nj] += recv[owner].sum(0)
    return (new % (1 << 32)).astype(np.uint32)


def params(name):
    """A parameter set by name; ``nano_n16`` is nano at N=16, where a CTA's
    n-tiles fill fewer blocks than there are warps and the warps split the
    k-chunks."""
    if name == "nano_n16":
        return dataclasses.replace(get_params("nano"), log_degree=4, name=name)
    return get_params(name)


def step_inputs(name, v_count, samples, kind, seed):
    p = params(name)
    k1, n = p.glwe_dimension + 1, p.degree
    rng = np.random.default_rng(seed)
    width = 4 * latk.n_groups(p, v_count) * n
    acc = rng.integers(0, 1 << 32, size=(samples, k1, n), dtype=np.uint32)
    bk = rng.integers(-128, 128, size=(1, k1 * 4, width), dtype=np.int8)
    a_v = rng.integers(0, 2 * n, size=(1, v_count, samples), dtype=np.int32)
    if kind == "worst":
        # every key byte -128; rot - acc = -2*acc = 0xF8F8F800 where a = N,
        # whose carry-chain digits are -8 and the +B anomaly 16 in turn
        bk[:] = -128
        acc[:] = 0x83838400
        a_v[:, 0] = n
    return p, acc, torch.from_numpy(bk), a_v


@pytest.mark.parametrize("name,v_count,cs,batch,kind", [
    ("nano", 1, 8, 1, "random"),
    ("nano", 1, 1, 3, "random"),
    ("nano", 3, 2, 2, "random"),
    ("nano", 3, 8, 1, "worst"),
    ("nano_n16", 1, 2, 1, "random"),
    ("nano_n16", 3, 1, 2, "worst"),
    ("test_insecure", 1, 16, 1, "random"),
    ("test_insecure", 1, 16, 1, "worst"),
    ("test_insecure", 1, 8, 2, "random"),
    ("test_insecure", 3, 16, 1, "random"),
    ("test_insecure", 3, 16, 1, "worst"),
])
def test_kernel_c_step_matches_twin(name, v_count, cs, batch, kind):
    """One step of the replayed kernel, each sample on its own cluster of cs
    CTAs, equals one step of ``blind_rotate_latency_ref`` bit for bit, on a
    random key and on the worst case (every key byte -128, digits -8 and
    +16)."""
    p, acc, bk, a_v = step_inputs(name, v_count, batch, kind, 300 + cs * 10 + batch)
    got = np.stack([kernel_c_step(p, acc[b], bk[0], a_v[0, :, b], cs) for b in range(batch)])
    want = latk.blind_rotate_latency_ref(p, to_torch_u32(acc), bk, torch.from_numpy(a_v))
    assert np.array_equal(got, to_numpy_u32(want))


@pytest.mark.parametrize("name,v_count", [("nano", 1), ("nano", 3), ("nano_n16", 1),
                                          ("test_insecure", 1), ("test_insecure", 3),
                                          ("large_4096", 1)])
def test_kernel_c_plans_cover_the_outputs_and_keys(name, v_count):
    """Under every cluster size ``derive`` takes, the consumer warps' n-tile
    blocks cover every output once in each k-split, the k-splits cover the
    CTA's k-chunks once, and the CTAs' k-chunks cover the step's key
    columns once."""
    p = params(name)
    k1, n = p.glwe_dimension + 1, p.degree
    plans = 0
    for cs in (16, 8, 4, 2, 1):
        sh = derive(n, k1, v_count, p.pbs_decomposer.levels, cs)
        if sh is None:
            continue
        plans += 1
        tiles = np.zeros((sh["ks"], n // 8), int)
        chunks = np.zeros(sh["cpc"], int)
        for warp in range(WARPS):
            kq = warp % sh["ks"]
            for k in range(sh["bpw"]):
                blk = warp // sh["ks"] + k * (WARPS // sh["ks"])
                tiles[kq, blk * sh["ntw"]:(blk + 1) * sh["ntw"]] += 1
            if warp < sh["ks"]:
                chunks[kq * sh["cpc"] // sh["ks"]:(kq + 1) * sh["cpc"] // sh["ks"]] += 1
        assert (tiles == 1).all() and (chunks == 1).all()
        assert cs * sh["cpc"] * 8 == sh["G"] * n
    assert plans > 0
