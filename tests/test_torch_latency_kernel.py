"""Kernel C's tensor-core step (``tfhe_tpu_torch/csrc/latency_kernel.cu``),
replayed on the CPU register by register, against its twin
``blind_rotate_latency_ref``: one step, and scans of up to 10 steps.

The replay follows the kernel's indexing: the plan's derived sizes and its
shared-memory layout (``derive``, ``fit``); each CTA's replica of the whole
accumulator, slice by slice; the digit phase's jobs and the bytes each
stores (``make_digits``), for every coefficient of the groups the CTA's
k-chunks touch; each consumer warp's n-tile block and k-split of the CTA's
k-chunks, walked in segments within one digit group; the A registers read
from the key operand's words as stored; the B registers read from the digit
word of offset (j0 + gid - t0 - tig) mod 2N through the window that rotates
through fixed registers; the mma.sync m16n8k32 fragment layouts of the PTX
ISA (A row-major, B column-major, C); the limb recombination across lanes 4
and 8 apart, the CTA's own slice of the accumulator added to its partials,
and each limb's lanes adding their words into the owner's sums mod 2^32;
and the owners' sums copied into every replica; over a scan, the three
sums buffers zeroed, filled and read in the kernel's order, each step's
digits made from the replicas the step before filled.  Every comparison is
bit-exact; each product is also checked to stay inside int32.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tfhe_tpu_torch.ops.cuda import latency_kernel as latk
from tfhe_tpu_torch.ops.torus import to_numpy_u32, to_torch_u32
from tfhe_tpu_torch.params import DecomposerParams, get_params

WARPS = 8  # consumer warps (latency_kernel.cu:kWarps)
MAX_NTW = 8
MAX_STAGES = 8
H100_SMEM = 232_448  # the H100's opt-in shared memory per block


def group_lo(sh, r):
    """The first digit group CTA r's k-chunks touch."""
    return r * sh["cpc"] // (sh["N"] // 8)


def group_hi(sh, r):
    """The last digit group CTA r's k-chunks touch."""
    return ((r + 1) * sh["cpc"] - 1) // (sh["N"] // 8)


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
    sh = dict(N=n, C=c, V=v, cs=cs, G=g, R4=4 * c, nj=nj, cpc=chunks // cs, ntw=ntw,
              ks=WARPS // blocks if blocks < WARPS else 1,
              bpw=1 if blocks < WARPS else blocks // WARPS)
    sh["GD"] = max(group_hi(sh, r) - group_lo(sh, r) + 1 for r in range(cs))
    return sh


def align(x):
    return -(-x // 128) * 128


def smem_bytes(sh, stages):
    """``latency_kernel.cu:layout``: the replica, ``dig``, the sums of three
    steps, the key stages and the mbarriers."""
    items, n = sh["C"] * sh["nj"], sh["N"]
    stage = align(sh["R4"] * (8 * sh["cpc"] + 4) * 4)
    return (align(sh["C"] * n * 4) + align(sh["GD"] * 2 * n * 4) + align(3 * items * 4)
            + stages * stage + (2 * stages + 2) * 8)


def fit(sh, budget=H100_SMEM):
    """``latency_kernel.cu:fit_stages``: the most key stages (up to
    MAX_STAGES) whose layout fits; None where one does not."""
    for stages in range(MAX_STAGES, 0, -1):
        if smem_bytes(sh, stages) <= budget:
            return stages
    return None


def plan(p, v_count, cs):
    """derive and fit at a parameter set; None where the entry point refuses
    the cluster size on the H100."""
    sh = derive(p.degree, p.glwe_dimension + 1, v_count, p.pbs_decomposer.levels, cs)
    stages = sh and fit(sh)
    if not stages:
        return None
    sh["stages"] = stages
    return sh


def make_digits(p, at, f0, nf, g0, r0, r1, a_v, dst):
    """The digit phase, as ``latency_kernel.cu:make_digits`` runs it, over
    its jobs (poly f, coefficient i): for each poly f0 <= f < f0 + nf
    (f = v*C + poly) and coefficient i < N, digit l of (rot_v - acc)[poly, i],
    rot_v[poly, i] = acc[poly, i - a_v], by round_value and the reference
    carry chain, is the byte of row (f+1)*levels - 1 - l; where that row lies
    in [r0, r1), it and its negation go to byte row mod 4 of words
    [row//4 - g0][sign][i] of dst (bytes, [groups][2][N][4]; where levels is
    even the kernel stores each pair of rows, an even row and the next, as
    one halfword).  at(poly, m) reads acc[poly, m].  Returns how often each
    byte was written."""
    dp = p.pbs_decomposer
    c, n = p.glwe_dimension + 1, p.degree
    lb, ig, levels = dp.log_base, dp.ignored_bits, dp.levels
    writes = np.zeros(dst.shape, int)
    i = np.arange(n)
    for f in range(f0, f0 + nf):
        v, poly = divmod(f, c)
        src = (i - (int(a_v[v]) & (2 * n - 1))) & (2 * n - 1)
        rot = at(poly, src & (n - 1)).astype(np.uint64)
        rot = np.where(src >= n, (1 << 32) - rot, rot) % (1 << 32)
        diff = (rot - at(poly, i).astype(np.uint64)) % (1 << 32)
        val = ((diff >> ig) + ((diff >> (ig - 1)) & 1)) if ig else diff
        carry = np.zeros(n, np.int64)
        for l in range(levels):
            res = ((val >> (lb * l)) & ((1 << lb) - 1)).astype(np.int64) + carry
            cm = res & (1 << (lb - 1))
            res = res - 2 * cm  # in [-B/2, B]: the +B anomaly stays
            carry = cm >> (lb - 1)
            row = (f + 1) * levels - 1 - l
            if r0 <= row < r1:
                for sign, x in enumerate((res, -res)):
                    dst[row // 4 - g0, sign, i, row % 4] = x.astype(np.int8).view(np.uint8)
                    writes[row // 4 - g0, sign, i, row % 4] += 1
    return writes


def slice_major(acc, cs):
    """acc u32 [C, N] -> the slices [cs][C][nj] (slice o: coefficients o*nj ..)."""
    c, n = acc.shape
    return acc.reshape(c, cs, n // cs).transpose(1, 0, 2).copy()


def make_digs(p, sh, replicas, a_v):
    """Each CTA's ``dig`` [GD][2][N] words after the digit phase, made from
    its replica [cs][C][nj] (slice o: coefficients o*nj ..): the rows of the
    groups its k-chunks touch, for every coefficient; and how often each of
    its bytes was written."""
    cs, n, nj, levels = sh["cs"], sh["N"], sh["nj"], p.pbs_decomposer.levels
    rows = sh["V"] * sh["C"] * levels
    digs = np.zeros((cs, sh["GD"], 2, n, 4), np.uint8)  # bytes, zeroed once
    writes = []
    for r in range(cs):
        def at(poly, m, rep=replicas[r]):  # acc[(m >> lgnj) * items + poly * nj + (m & (nj - 1))]
            return rep[m // nj, poly, m % nj]

        g0, gn = group_lo(sh, r), group_hi(sh, r) - group_lo(sh, r) + 1
        r0, r1 = 4 * g0, min(4 * (g0 + gn), rows)
        f0 = r0 // levels
        writes.append(make_digits(p, at, f0, (r1 - 1) // levels - f0 + 1, g0, r0, r1, a_v,
                                  digs[r]))
    return words(digs), writes


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


def contract(p, sh, replicas, bk_step, a_v):
    """The digit phase and the contraction of one step in every CTA of a
    cluster, from their replicas [cs][cs][C][nj]: what each owner's sums
    receive, u64 [cs][C][nj] mod 2^32 (every CTA's partials of the owner's
    slice, and the owner's own slice of the accumulator)."""
    cs, c, n = sh["cs"], sh["C"], sh["N"]
    g_tot, r4, nj, cpc, ntw, ks = (sh[k] for k in ("G", "R4", "nj", "cpc", "ntw", "ks"))
    assert bk_step.shape == (r4, 4 * g_tot * n)
    digs, _ = make_digs(p, sh, replicas, a_v)
    key = words(bk_step.numpy().view(np.uint8).reshape(r4, g_tot * n, 4))  # u32 [R4, G*N]
    lane, gid, tig = _LANE, _GID, _TIG
    mask2, cpg, kw = 2 * n - 1, n // 8, 8 * cpc
    # sums[owner][C][nj]: zeroed, then every CTA's part of the owner's slice added
    sums = np.zeros((cs, c, nj), np.uint64)
    for rank in range(cs):
        dig = digs[rank].reshape(-1)
        glo = group_lo(sh, rank)
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

                    def word(m, g=g):  # dig[g - group_lo(rank)][m mod 2N]
                        return dig[(g - glo) * 2 * n + (m & mask2)]

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
                        # the CTA's own slice of its replica rides with its partials
                        own = replicas[rank, rank, col[ln], j % nj] if j // nj == rank and kq == 0 else 0
                        part[kq, j // nj, col[ln], j % nj] = (x[nn, ln, l_of[ln]] + own) % (1 << 32)
        sums += part.sum(0)  # the k-splits summed, each owner's part added into its sums
    return sums % (1 << 32)


def copy_into_replicas(replicas, sums):
    """The all-gather: owner o's sums [cs][C][nj] into slice o of every
    replica, its own included."""
    for o in range(sums.shape[0]):
        replicas[:, o] = sums[o]


def from_slices(s):
    """[..., cs, C, nj] slices -> [..., C, N] u32."""
    return np.moveaxis(s, -3, -2).reshape(*s.shape[:-3], s.shape[-2], -1).astype(np.uint32)


def kernel_c_step(p, acc, bk_step, a_v, cs):
    """One step of the kernel on one sample's cluster of cs CTAs: acc u32
    [C, N], the step's key operand int8 [C*4, 4*G*N], exponents [V] -> (the
    new accumulator u32 [C, N], every CTA's replica [cs][C, N] after the
    owners' sums have been copied into it)."""
    c, n = acc.shape
    sh = plan(p, a_v.shape[0], cs)
    assert sh is not None and sh["C"] == c and sh["N"] == n
    replicas = np.stack([slice_major(acc, cs) for _ in range(cs)])  # [cs][cs][C][nj]
    sums = contract(p, sh, replicas, bk_step, a_v)
    copy_into_replicas(replicas, sums)
    return from_slices(sums), from_slices(replicas)


#: the buffers ``sums`` rotates through (latency_kernel.cu: sums [3][C][nj])
SUMS_BUFFERS = 3


def sums_schedule(n_steps, buffers=SUMS_BUFFERS):
    """The kernel's uses of its sums buffers over a scan, in order, as
    (step, use, buffer): in step s, after the consumers' barrier that ends
    the digit phase, ("zero", the buffer of step s + buffers - 1); the
    partials of every CTA ("add") into the buffer of step s; once they have
    all arrived, ("copy") of it into every replica, but in the last step;
    after the scan, ("result", the buffer of the last step).  The buffer of
    step s is s mod buffers; all start at 0 before the cluster's first
    barrier."""
    events = []
    for s in range(n_steps):
        events.append((s, "zero", (s + buffers - 1) % buffers))
        events.append((s, "add", s % buffers))
        if s + 1 < n_steps:
            events.append((s, "copy", s % buffers))
    if n_steps:
        events.append((n_steps, "result", (n_steps - 1) % buffers))
    return events


def check_sums_schedule(events, buffers=SUMS_BUFFERS):
    """Asserts that the schedule needs no barrier beyond the kernel's.  A
    buffer that other CTAs add into in step s holds 0: its zeroing is
    ordered before their adds only through a barrier of the zeroing CTA's
    consumers that lies after the zeroing and before the copies of step
    s - 1, after which the other CTAs start step s, so it was zeroed in step
    s - 2 or before (or before the launch's barrier), and not added into
    since.  A buffer is zeroed only once its adds have been read (copied, in
    an earlier step, whose copies the zeroing step's barrier follows) and
    never while it is the buffer of the zeroing step.  The result is the
    last step's adds."""
    zeroed = [-(1 << 30)] * buffers  # the step whose zeroing left it at 0
    clean = [True] * buffers  # at 0: zeroed, not added into since
    unread = [False] * buffers  # added into, not read since
    for step, use, x in events:
        if use == "zero":
            assert not unread[x] and x != step % buffers, (step, x)
            if not clean[x]:
                zeroed[x], clean[x] = step, True
        elif use == "add":
            assert clean[x] and zeroed[x] <= step - 2, (step, x, zeroed[x])
            clean[x], unread[x] = False, True
        elif use == "copy":
            unread[x] = False
        else:
            assert unread[x] and use == "result"


def kernel_c_scan(p, acc, bk, a_v, cs):
    """The kernel's step loop on one sample's cluster of cs CTAs: acc u32
    [C, N], key operand int8 [n_steps, C*4, 4*G*N], exponents [n_steps, V]
    -> (the result u32 [C, N], read from the last step's sums, and every
    CTA's replica [cs][C, N] as the last copy left it).  Each step's digit
    phase reads the replicas the previous step's copy filled, and its
    partials go into the sums buffer of the step, as ``sums_schedule``
    zeroes, fills and reads the buffers."""
    c, n = acc.shape
    sh = plan(p, a_v.shape[1], cs)
    assert sh is not None and sh["C"] == c and sh["N"] == n
    events = sums_schedule(bk.shape[0])
    check_sums_schedule(events)
    replicas = np.stack([slice_major(acc, cs) for _ in range(cs)])
    bufs = np.zeros((SUMS_BUFFERS, cs, c, sh["nj"]), np.uint64)
    result = None
    for step, use, x in events:
        if use == "zero":
            bufs[x] = 0
        elif use == "add":
            bufs[x] = (bufs[x] + contract(p, sh, replicas, bk[step], a_v[step])) % (1 << 32)
        elif use == "copy":
            copy_into_replicas(replicas, bufs[x])
        else:
            result = from_slices(bufs[x])
    return result, from_slices(replicas)


def params(name):
    """A parameter set by name; ``nano_n16`` is nano at N=16, where a CTA's
    n-tiles fill fewer blocks than there are warps and the warps split the
    k-chunks; ``test_insecure_l5`` is test_insecure with 5 levels of 4 bits,
    where polys' rows start at odd rows."""
    if name == "nano_n16":
        return dataclasses.replace(get_params("nano"), log_degree=4, name=name)
    if name == "test_insecure_l5":
        return dataclasses.replace(get_params("test_insecure"), name=name,
                                   pbs_decomposer=DecomposerParams(log_base=4, levels=5, log_q=32))
    return get_params(name)


def step_inputs(name, v_count, samples, kind, seed, steps=1):
    p = params(name)
    k1, n = p.glwe_dimension + 1, p.degree
    rng = np.random.default_rng(seed)
    width = 4 * latk.n_groups(p, v_count) * n
    acc = rng.integers(0, 1 << 32, size=(samples, k1, n), dtype=np.uint32)
    bk = rng.integers(-128, 128, size=(steps, k1 * 4, width), dtype=np.int8)
    a_v = rng.integers(0, 2 * n, size=(steps, v_count, samples), dtype=np.int32)
    if kind == "worst":
        # every key byte -128; rot - acc = -2*acc = 0xF8F8F800 where a = N
        # (variant 0 of step 0), whose carry-chain digits are -8 and the +B
        # anomaly 16 in turn
        bk[:] = -128
        acc[:] = 0x83838400
        a_v[0, 0] = n
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
    ("test_insecure_l5", 1, 16, 2, "random"),
    ("test_insecure_l5", 3, 8, 1, "random"),
])
def test_kernel_c_step_matches_twin(name, v_count, cs, batch, kind):
    """One step of the replayed kernel, each sample on its own cluster of cs
    CTAs, equals one step of ``blind_rotate_latency_ref`` bit for bit, on a
    random key and on the worst case (every key byte -128, digits -8 and
    +16)."""
    p, acc, bk, a_v = step_inputs(name, v_count, batch, kind, 300 + cs * 10 + batch)
    got = np.stack([kernel_c_step(p, acc[b], bk[0], a_v[0, :, b], cs)[0] for b in range(batch)])
    want = latk.blind_rotate_latency_ref(p, to_torch_u32(acc), bk, torch.from_numpy(a_v))
    assert np.array_equal(got, to_numpy_u32(want))


PLAN_SHAPES = [("nano", 1), ("nano", 3), ("nano_n16", 1), ("test_insecure", 1),
               ("test_insecure", 3), ("large_4096", 1)]


@pytest.mark.parametrize("name,v_count", PLAN_SHAPES)
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


@pytest.mark.parametrize("name,v_count", PLAN_SHAPES)
def test_kernel_c_buffers_cover_every_read(name, v_count):
    """Under every plan the H100 takes: each CTA's k-chunks read digit words
    only of groups its ``dig`` holds (at most GD, from group_lo on); its
    digit phase writes every digit byte of those groups once a step and the
    bytes of rows past V*R never; every coefficient sits in one owner's
    slice; the layout fits the budget."""
    p = params(name)
    n, levels = p.degree, p.pbs_decomposer.levels
    rng = np.random.default_rng(7)
    plans = 0
    for cs in (16, 8, 4, 2, 1):
        sh = plan(p, v_count, cs)
        if sh is None:
            continue
        plans += 1
        assert smem_bytes(sh, sh["stages"]) <= H100_SMEM
        rows = v_count * sh["C"] * levels
        owners = np.zeros(n, int)
        for o in range(cs):
            owners[o * sh["nj"]:(o + 1) * sh["nj"]] += 1
        assert (owners == 1).all()
        acc = rng.integers(0, 1 << 32, size=(sh["C"], n), dtype=np.uint32)
        replicas = np.stack([slice_major(acc, cs) for _ in range(cs)])
        _, writes = make_digs(p, sh, replicas, rng.integers(0, 2 * n, size=v_count))
        for r in range(cs):
            glo, gn = group_lo(sh, r), group_hi(sh, r) - group_lo(sh, r) + 1
            assert gn <= sh["GD"]
            # the groups of the CTA's k-chunks, k-chunk q of the step in group q // (N/8)
            read = {(r * sh["cpc"] + q) // (n // 8) for q in range(sh["cpc"])}
            assert read == set(range(glo, glo + gn))
            # bytes [gl][sign][i][row % 4] of row 4 * (glo + gl) + row % 4
            row = 4 * (glo + np.arange(sh["GD"]))[:, None, None, None] + np.arange(4)
            want = ((row < rows) & (row < 4 * (glo + gn))).astype(int)
            assert (writes[r] == np.broadcast_to(want, writes[r].shape)).all()
    assert plans > 0


@pytest.mark.parametrize("name,v_count,cs,kind", [
    ("nano", 1, 8, "random"), ("nano", 3, 4, "worst"), ("test_insecure", 1, 16, "random"),
    ("test_insecure", 1, 4, "worst"), ("test_insecure", 3, 8, "random")])
def test_kernel_c_replicas_equal_the_twin_after_a_step(name, v_count, cs, kind):
    """After one replayed step every CTA's replica equals the twin's
    accumulator bit for bit."""
    p, acc, bk, a_v = step_inputs(name, v_count, 1, kind, 400 + cs)
    _, replicas = kernel_c_step(p, acc[0], bk[0], a_v[0, :, 0], cs)
    want = to_numpy_u32(latk.blind_rotate_latency_ref(p, to_torch_u32(acc), bk,
                                                      torch.from_numpy(a_v)))[0]
    assert replicas.shape == (cs, *want.shape)
    assert all(np.array_equal(rep, want) for rep in replicas)


@pytest.mark.parametrize("name,v_count,cs,steps,kind", [
    ("nano", 1, 8, 9, "random"), ("nano", 3, 2, 10, "worst"), ("nano_n16", 1, 2, 8, "random"),
    ("test_insecure", 3, 2, 8, "random")])
def test_kernel_c_scan_matches_twin(name, v_count, cs, steps, kind):
    """A replayed scan long enough to reuse every sums buffer at least twice,
    each step's digits made from the replicas the step before filled, equals
    the twin bit for bit; so does every CTA's replica after the last copy,
    against the twin one step short."""
    p, acc, bk, a_v = step_inputs(name, v_count, 1, kind, 500 + steps, steps)
    got, replicas = kernel_c_scan(p, acc[0], bk, a_v[:, :, 0], cs)
    twin = latk.blind_rotate_latency_ref
    want = to_numpy_u32(twin(p, to_torch_u32(acc), bk, torch.from_numpy(a_v)))[0]
    before_last = to_numpy_u32(twin(p, to_torch_u32(acc), bk[:-1],
                                    torch.from_numpy(a_v[:-1])))[0]
    assert np.array_equal(got, want)
    assert all(np.array_equal(rep, before_last) for rep in replicas)


@pytest.mark.parametrize("steps", [1, 2, 3, 4, 8, 9, 10])
def test_kernel_c_sums_buffers_need_no_barrier(steps):
    """Over scans of every length modulo the three buffers, each sums buffer
    is zeroed in time for its adds, behind a barrier, and never before it
    has been read."""
    check_sums_schedule(sums_schedule(steps))


def test_two_sums_buffers_would_need_a_barrier():
    """With two buffers a buffer is zeroed in the step before its reuse, and
    only the same step's copies, which no barrier of the zeroing threads
    precedes, would order the zeroing before the other CTAs' adds: the
    check refuses it from the first reuse on, a 3-step scan."""
    check_sums_schedule(sums_schedule(2, buffers=2), buffers=2)
    with pytest.raises(AssertionError):
        check_sums_schedule(sums_schedule(3, buffers=2), buffers=2)


@pytest.mark.parametrize("name,v_count,fits", [
    # the card tests' forced cluster sizes at N=512 (tests/test_torch_cuda.py)
    ("test_insecure", 1, [16, 8, 4, 2, 1]),
    ("test_insecure", 3, [16, 8, 4, 2]),
    ("default_128", 1, [16, 8, 4, 2, 1]),
    ("large_2048", 3, [16, 8, 4]),
    ("large_4096", 3, [16])])
def test_kernel_c_plans_fit_the_card(name, v_count, fits):
    """The cluster sizes whose replica, digit words, partials, sums and one
    key stage fit the H100's shared memory at each shape."""
    p = params(name)
    assert [cs for cs in (16, 8, 4, 2, 1) if plan(p, v_count, cs)] == fits
