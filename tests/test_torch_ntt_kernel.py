"""Kernel D's data layout, replayed on the CPU.

``csrc/ntt_kernel.cu`` runs only on the card.  These tests replay its index
arithmetic lane by lane in numpy -- the ldmatrix row addresses, the
m16n8k32/m16n8k16 fragment layouts, the swizzled digit and Ch rows, the Dh
blocks of a pass's CRT primes and the CTAs of a cluster row they are
written to, the one Dh and one Ch exchange a pass (one pass of both primes
a step, or two of one prime each), the 4-bin packing of Ch, the inverse's
triple groups and its CRT lift (in registers, or from the first pass's
residues), the key stages (one prime's slice each, taken a pass's primes
at a time) and their chunks -- and hold one cluster row's result against
the plain twin (``blind_rotate_nttf_ref``) bit for bit.  Every mma's sums are checked to
stay inside int32, and the bytes the kernel reads but must not use (padding
rows, key-stage slack) are filled with random bytes.  The card tests in
``tests/test_torch_cuda.py`` hold the kernel itself against the twin.
"""

from dataclasses import dataclass

import numpy as np
import pytest
import torch

from tfhe_tpu_torch.ops import ntt
from tfhe_tpu_torch.ops.cuda import ntt_kernel as nttk
from tfhe_tpu_torch.ops.torus import to_numpy_u32, to_torch_u32
from tfhe_tpu_torch.params import get_params

P1, P2 = ntt.PRIMES
N1, ROW, GROUP = 64, 64, 8
LANE = np.arange(32)
GID, TIG = LANE >> 2, LANE & 3


def center(x, p):
    """The kernel's center<P>: C's truncating %, then into [-p/2, p/2]."""
    r = np.fmod(x, p)
    return np.where(r > p // 2, r - p, np.where(r < -(p // 2), r + p, r))


def split2(x):
    lo = ((x + 128) & 255) - 128
    return (x - lo) >> 8, lo


def ldm(buf, addrs, nmat):
    """ldmatrix: lane 8m+j gives row j's address of matrix m; lane L
    receives bytes 4*(L%4)..+3 of row L//4 of each matrix -> [32, nmat, 4]."""
    src = np.stack([addrs[8 * m + LANE // 4] for m in range(nmat)], 1)  # [32, nmat]
    idx = src[..., None] + 4 * TIG[:, None, None] + np.arange(4)
    return buf[idx].astype(np.int64)


def mma(c, a, b):
    """c[32, 4] += the m16n8k(16 * len(a regs) / 2) product of the lanes'
    fragments a [32, 4 or 2, 4], b [32, 2 or 1, 4]."""
    k = 16 * b.shape[1]
    amat = np.zeros((16, k), np.int64)
    bmat = np.zeros((k, 8), np.int64)
    for r in range(a.shape[1]):
        rows, cols = GID + 8 * (r % 2), 16 * (r // 2) + 4 * TIG
        amat[rows[:, None], cols[:, None] + np.arange(4)] = a[:, r]
    for r in range(b.shape[1]):
        bmat[(16 * r + 4 * TIG)[:, None] + np.arange(4), GID[:, None]] = b[:, r]
    d = amat @ bmat
    c += np.stack([d[GID, 2 * TIG], d[GID, 2 * TIG + 1], d[GID + 8, 2 * TIG],
                   d[GID + 8, 2 * TIG + 1]], 1)
    assert np.abs(c).max() < 2**31


def swz(row, chunk):
    return row * ROW + ((chunk ^ ((row >> 1) & 3)) << 4)


@dataclass
class Shape:
    """The C entry point's Shape for one plan (its layout())."""
    S: int
    split: int
    C: int
    N: int
    levels: int
    L: int
    mcs: int
    np: int = 2  # CRT primes a pass

    def __post_init__(self):
        self.N2 = self.N // N1
        self.RN2 = self.C * self.levels * self.N2
        self.RN2p = -(-self.RN2 // 16) * 16
        self.CLN2 = self.C * self.L * self.N2
        self.MT = -(-self.CLN2 // 8)
        self.nchunks = -(-self.MT // self.mcs)
        self.T = self.S * self.C * self.N2
        self.ngroups = -(-self.T // 4)
        self.bins = N1 // self.split
        self.nt = -(-2 * self.S * self.split // 8)
        self.blk_dh = self.bins * 2 * self.S * self.RN2p  # one prime's part of a block
        self.blk_ch = self.S * self.CLN2 * 2 * self.bins
        self.dhs = self.np * self.blk_dh + 32 * self.S
        self.chs = self.np * self.blk_ch + 64


class Cta:
    """One CTA's shared memory; the bytes it never writes are random."""

    def __init__(self, sh, acc, rng):
        self.acc = acc
        self.dig = np.zeros(sh.S * sh.RN2p * ROW, np.int8)  # rows past RN2 stay 0
        self.dh = rng.integers(-128, 128, sh.split * sh.dhs).astype(np.int8)  # received
        self.ch = rng.integers(-128, 128, sh.split * sh.chs).astype(np.int8)
        self.dh_out = rng.integers(-128, 128, sh.split * sh.np * sh.blk_dh).astype(np.int8)
        self.ch_out = rng.integers(-128, 128, sh.split * sh.np * sh.blk_ch).astype(np.int8)
        # the first prime's residues [T][L][N1 + 2], with one prime a pass
        self.r1 = rng.integers(-2**15, 2**15, (sh.T, sh.L, N1 + 2)).astype(np.int16)


def replay(p, acc0, bk_lhs, a_hat, S, split, mcs, rng, np_=2):
    """One row of `split` CTAs of S samples each (acc0 holds them, zero-padded
    to S*split) through every step, as the kernel's consumer warps compute it,
    in passes of ``np_`` primes: each CTA transforms its samples for all bins
    and the pass's primes into the owners' Dh, then contracts its bins for
    all the row's samples and the pass's primes into the owners' Ch, then
    inverts (and lifts) its own samples."""
    dp = p.pbs_decomposer
    plan = ntt.plan_for_params(p)
    k1 = p.glwe_dimension + 1
    sh = Shape(S, split, k1, p.degree, dp.levels, plan.key_limbs, mcs, np_)
    N, CN, CLN2 = sh.N, k1 * sh.N, sh.CLN2
    nb = acc0.shape[0]
    frags = nttk.kernel_tables(N1, "cpu").numpy().reshape(2, 2, 8, 32, 2, 16)
    acc = np.zeros((S * split, CN), np.uint32)
    acc[:nb] = to_numpy_u32(acc0).reshape(nb, CN)
    ctas = [Cta(sh, acc[g * S:(g + 1) * S], rng) for g in range(split)]
    key = bk_lhs.numpy().reshape(bk_lhs.shape[0], 2, N1, 2 * CLN2 * sh.RN2)
    ah = a_hat.numpy()
    for step in range(key.shape[0]):
        for g, cta in enumerate(ctas):
            exps = [int(ah[step, g * S + s]) & (2 * N - 1) if g * S + s < nb else 0
                    for s in range(S)]
            digits(sh, dp, cta, exps)
        for p0 in range(0, 2, np_):
            primes = range(p0, p0 + np_)
            for cta in ctas:
                forward(sh, frags[:, 0], cta, primes)
            exchange(ctas, "dh", np_ * sh.blk_dh, sh.dhs)
            for g, cta in enumerate(ctas):
                # a thread's ph[prime of the pass][j][nt], by m-tile
                ph = np.zeros((np_, sh.MT, sh.nt, 32), np.int64)
                pl = np.zeros((np_, sh.MT, sh.nt, 32), np.int64)
                for bl in range(sh.bins):
                    for chunk in range(sh.nchunks):
                        q0 = chunk * 8 * mcs
                        rows = min(8 * mcs, CLN2 - q0)
                        stages = []  # the chunk of the bin's slice of each prime, in turn
                        for prime in primes:
                            sl = key[step, prime, g * sh.bins + bl]
                            stage = rng.integers(-128, 128,
                                                 2 * rows * sh.RN2 + 16).astype(np.int8)
                            stage[:rows * sh.RN2] = sl[q0 * sh.RN2:(q0 + rows) * sh.RN2]
                            stage[rows * sh.RN2:2 * rows * sh.RN2] = \
                                sl[(CLN2 + q0) * sh.RN2:(CLN2 + q0 + rows) * sh.RN2]
                            stages.append(stage)
                        contract_stage(sh, stages, chunk, cta, bl, ph, pl, primes)
            exchange(ctas, "ch", np_ * sh.blk_ch, sh.chs)
            for cta in ctas:
                inverse(sh, frags[:, 1], cta, plan.key_bits, k1, primes)
    return to_torch_u32(acc[:nb].reshape(nb, k1, N))


def digits(sh, dp, cta, exps):
    N, CN, N2 = sh.N, sh.C * sh.N, sh.N2
    for idx in range(sh.S * CN):
        sb, rem = divmod(idx, CN)
        poly, m = divmod(rem, N)
        src = (m - exps[sb]) & (2 * N - 1)
        rot = int(cta.acc[sb, poly * N + (src & (N - 1))])
        if src >= N:
            rot = (-rot) & 0xFFFFFFFF
        diff = (rot - int(cta.acc[sb, rem])) & 0xFFFFFFFF
        i, j1 = divmod(m, N2)
        ig, lb = dp.ignored_bits, dp.log_base
        v = ((diff >> ig) + ((diff >> (ig - 1)) & 1)) & 0xFFFFFFFF if ig else diff
        carry = 0
        for lv in range(dp.levels):
            res = ((v >> (lb * lv)) & ((1 << lb) - 1)) + carry
            cm = res & (1 << (lb - 1))
            res -= cm << 1
            carry = cm >> (lb - 1)
            row = sb * sh.RN2p + (poly * dp.levels + dp.levels - 1 - lv) * N2 + j1
            cta.dig[swz(row, i >> 4) + (i & 15)] = res


def exchange(ctas, name, blk, stride):
    """The bulk copies of a row: sender g's outgoing block o into CTA o's
    received buffer at g's place."""
    for g, sender in enumerate(ctas):
        for o, receiver in enumerate(ctas):
            getattr(receiver, name)[g * stride:g * stride + blk] = \
                getattr(sender, name + "_out")[o * blk:(o + 1) * blk]


def forward(sh, frag, cta, primes):
    """``forward``: this CTA's samples, all bins and the pass's ``primes``
    (``frag`` holds each prime's w_fwd fragments), into its outgoing Dh."""
    RN2p, ntl = sh.RN2p, sh.S * sh.RN2p // 8
    for un in range(8 * ntl):
        g, nt = divmod(un, ntl)
        row0 = nt * 8
        b = ldm(cta.dig, swz(row0 + (LANE & 7), LANE >> 3), 4)  # the same for every prime
        for j, prime in enumerate(primes):
            P = ntt.PRIMES[prime]
            fa = frag[prime, g].astype(np.int64)  # [32, 2 k-steps, 16 bytes]
            c = np.zeros((32, 4), np.int64)
            mma(c, fa[:, 0].reshape(32, 4, 4), b[:, 0:2])
            mma(c, fa[:, 1].reshape(32, 4, 4), b[:, 2:4])
            (h0, l0), (h1, l1) = (split2(center(c[:, k] * 256 + c[:, k + 2], P)) for k in (0, 1))
            hi = (h0 & 0xFF) | (h1 & 0xFF) << 8
            lo = (l0 & 0xFF) | (l1 & 0xFF) << 8
            # lanes tig, tig^1 trade halves (__shfl_xor_sync): the even one
            # stores the hi bytes of their 4 columns, the odd one the lo bytes
            give = np.where(TIG & 1, hi, lo)
            got = give[LANE ^ 1]
            word = np.where(TIG & 1, got | lo << 16, hi | got << 16)
            sb = row0 // RN2p
            col = row0 - sb * RN2p + 4 * (TIG >> 1)
            # [owner][own bin][prime][sample, plane]: the owners' blocks follow one another
            at = ((((g * GROUP + GID) * sh.np + j) * sh.S + sb) * 2 + (TIG & 1)) * RN2p + col
            for ln in range(32):
                cta.dh_out[at[ln]:at[ln] + 4] = np.frombuffer(
                    int(word[ln]).to_bytes(4, "little"), np.int8)


def inverse(sh, frag, cta, key_bits, k1, primes):
    """``inverse``: this CTA's samples, all bins, from its own Ch of the
    pass's ``primes`` (``frag`` holds each prime's w_inv fragments): with
    both, lifted by CRT in registers; with one, the first prime's residues
    go to ``cta.r1`` and the second prime lifts them."""
    N2, CLN2, L = sh.N2, sh.CLN2, sh.L
    inv_p1 = pow(P1, P2 - 2, P2)
    bins = sh.bins
    for un in range(8 * sh.ngroups):
        mt, u = divmod(un, sh.ngroups)
        tl = np.minimum(4 * u + (GID >> 1), sh.T - 1)
        jl, cl, sl_ = tl % N2, (tl // N2) % k1, tl // (N2 * k1)
        to, i = 4 * u + TIG, mt * 8 + GID
        ok = to < sh.T
        k = 16 * np.arange(4)[None, :] + 4 * TIG[:, None]  # [32 lanes, 4 registers]
        col = (k // bins) * sh.chs + k % bins + ((sl_ * CLN2 * 2 + (GID & 1)) * bins)[:, None]
        delta = np.zeros(32, np.int64)
        for lam in range(L):
            off = (((cl * L + lam) * N2 + jl) * 2 * bins)[:, None]
            res = []
            for j, prime in enumerate(primes):
                P = ntt.PRIMES[prime]
                inv = frag[prime].astype(np.int64)
                at = col + off + j * sh.blk_ch
                b = cta.ch[at[..., None] + np.arange(4)].astype(np.int64)  # [32, 4, 4]
                c = np.zeros((32, 4), np.int64)
                mma(c, inv[mt, :, 0].reshape(32, 4, 4), b[:, 0:2])
                mma(c, inv[mt, :, 1].reshape(32, 4, 4), b[:, 2:4])
                res.append(center(center(c[:, 0] * 256 + c[:, 1] + c[:, 2], P) * 256 + c[:, 3],
                                  P))
            if len(res) == 2:
                r1, r2 = res
            elif primes[0] == 0:
                for ln in np.nonzero(ok)[0]:
                    cta.r1[to[ln], lam, i[ln]] = res[0][ln]
                continue
            else:
                r1 = np.where(ok, cta.r1[np.minimum(to, sh.T - 1), lam, i], 0).astype(np.int64)
                r2 = res[0]
            assert np.abs((r2 - r1) * inv_p1).max() < 2**31
            sv = (r1 + P1 * center((r2 - r1) * inv_p1, P2)) & 0xFFFFFFFF
            delta += (sv << (key_bits * lam)) & 0xFFFFFFFF
        if len(primes) == 1 and primes[0] == 0:
            continue
        for ln in np.nonzero(ok)[0]:
            t = int(to[ln])
            jo, co, so = t % N2, (t // N2) % k1, t // (N2 * k1)
            w = co * sh.N + int(i[ln]) * N2 + jo
            cta.acc[so, w] = (int(cta.acc[so, w]) + int(delta[ln])) & 0xFFFFFFFF


def contract_stage(sh, stages, chunk, cta, bl, ph, pl, primes):
    """``contract`` of a pass's key stages (the chunk of bin bl's slice of
    each of its ``primes``) by every warp: this CTA's bin bl for all the
    row's samples and those primes, unit (m-tile, n-tile) by unit, into its
    outgoing Ch."""
    RN2, CLN2, S = sh.RN2, sh.CLN2, sh.S
    q0 = chunk * 8 * sh.mcs
    rows = min(8 * sh.mcs, CLN2 - q0)
    use_ldm = RN2 % 16 == 0
    nk32, tail, slots = sh.RN2p // 32, sh.RN2p & 16, S * sh.split
    dhp = 2 * S * sh.RN2p  # a prime's Dh rows follow the one's before
    for u in range(sh.MT * sh.nt):  # the units; consumer warp w takes m-tiles w, w + 9, ...
        mt, nt = u % sh.MT, u // sh.MT
        base = mt * 8 - q0
        if not 0 <= base < rows:  # not in this stage
            continue
        lq = np.minimum(base + (LANE & 7), rows - 1)
        gq = np.minimum(base + GID, rows - 1)
        arow = np.where((LANE >> 3) & 1, rows + lq, lq) * RN2 + 16 * (LANE >> 4)
        ahi, alo = gq * RN2 + 4 * TIG, (rows + gq) * RN2 + 4 * TIG
        n = 8 * nt + (LANE & 7)
        slot = np.where(n < 2 * slots, n >> 1, 0)
        brow = ((slot // S) * sh.dhs
                + (bl * 2 * sh.np * S + 2 * (slot % S) + (n & 1)) * sh.RN2p)
        sh8, q, slot = 8 * (bl & 3), mt * 8 + GID, 4 * nt + TIG
        for j, prime in enumerate(primes):
            P = ntt.PRIMES[prime]
            stage, b_row = stages[j], brow + j * dhp

            def plain(k0, nregs):
                offs = [ahi + k0, alo + k0, ahi + k0 + 16, alo + k0 + 16][:nregs]
                return np.stack([stage[o[:, None] + np.arange(4)] for o in offs],
                                1).astype(np.int64)

            c = np.zeros((32, 4), np.int64)
            for ks in range(nk32):
                k0 = 32 * ks
                a = ldm(stage, arow + k0, 4) if use_ldm else plain(k0, 4)
                mma(c, a, ldm(cta.dh, b_row + k0 + 16 * ((LANE >> 3) & 1), 2))
            if tail:
                k0 = 32 * nk32
                a = ldm(stage, arow + k0, 2) if use_ldm else plain(k0, 2)
                mma(c, a, ldm(cta.dh, b_row + k0, 1))
            hi, lo = split2(center(center(c[:, 0] * 256 + c[:, 1] + c[:, 2], P) * 256 + c[:, 3],
                                   P))
            ph[j, mt, nt] = (ph[j, mt, nt] if bl & 3 else 0) | ((hi & 0xFF) << sh8)
            pl[j, mt, nt] = (pl[j, mt, nt] if bl & 3 else 0) | ((lo & 0xFF) << sh8)
            if bl & 3 != 3:
                continue
            for ln in np.nonzero((slot < slots) & (q < CLN2))[0]:
                owner, s_o = divmod(int(slot[ln]), S)
                at = ((sh.np * owner + j) * sh.blk_ch
                      + (s_o * CLN2 + int(q[ln])) * 2 * sh.bins + (bl & ~3))
                words = ph[j, mt, nt, ln], pl[j, mt, nt, ln]
                for a_, word in zip((at, at + sh.bins), words):
                    cta.ch_out[a_:a_ + 4] = np.frombuffer(int(word).to_bytes(4, "little"),
                                                          np.int8)


def replay_inputs(name, batch, steps, seed, key="random"):
    p = get_params(name)
    k1, n = p.glwe_dimension + 1, p.degree
    rng = np.random.default_rng(seed)
    shape = (steps, k1 * p.pbs_decomposer.levels, k1, n)
    bk = to_torch_u32(rng.integers(0, 1 << 32, size=shape, dtype=np.uint32))
    bk_lhs = ntt.ntt_key_lhs_form(ntt.make_ep_ntt_key(bk, ntt.plan_for_params(p)))
    acc0 = to_torch_u32(rng.integers(0, 1 << 32, size=(batch, k1, n), dtype=np.uint32))
    a_hat = torch.from_numpy(rng.integers(0, 2 * n, size=(steps, batch), dtype=np.int32))
    if key == "worst":  # key bytes -128; rot - acc = 0xF8F8F800: digits -8 and the +B anomaly 16
        bk_lhs = torch.full_like(bk_lhs, -128)
        acc0 = to_torch_u32(np.full((batch, k1, n), 0x83838400, np.uint32))
        a_hat[0] = n
    return p, acc0, bk_lhs, a_hat, rng


@pytest.mark.parametrize("name,batch,spc,split,mcs,key", [
    ("nano", 1, 1, 1, 1, "random"),           # RN2=12: plain loads, a k16 tail, padded rows
    ("nano", 5, 2, 4, 1, "random"),           # a partly filled row of CTAs
    ("test_insecure", 16, 2, 8, 9, "random"),  # default_128's shape and plan
    ("test_insecure", 6, 4, 2, 9, "random"),  # 4 samples per CTA, 2 n-tiles
    ("test_insecure", 2, 1, 2, 4, "random"),  # chunked key stages (large_2048's scheme)
    ("test_insecure", 7, 2, 4, 9, "worst"),   # the largest digits and key bytes: sums at bound
    ("test_insecure", 8, 1, 8, 9, "worst"),   # the same at default_128's B=64 plan (1, 8)
])
def test_kernel_d_replay_matches_twin(name, batch, spc, split, mcs, key):
    p, acc0, bk_lhs, a_hat, rng = replay_inputs(name, batch, 1, 300 + batch, key)
    got = replay(p, acc0, bk_lhs, a_hat, spc, split, mcs, rng)
    assert torch.equal(got, nttk.blind_rotate_nttf_ref(p, acc0, bk_lhs, a_hat))


@pytest.mark.parametrize("name,batch,spc,split,key", [
    ("nano", 1, 1, 1, "random"),  # plain loads, a k16 tail, padded rows
    ("nano", 5, 2, 4, "worst"),   # a partly filled row of CTAs; sums at their bound
])
def test_kernel_d_replay_one_prime_a_pass_matches_twin(name, batch, spc, split, key):
    """The plan large_2048 takes, where both primes' blocks do not fit: two
    passes of one prime a step, the first prime's residues kept for the
    lift."""
    p, acc0, bk_lhs, a_hat, rng = replay_inputs(name, batch, 2, 400 + batch, key)
    got = replay(p, acc0, bk_lhs, a_hat, spc, split, 1, rng, np_=1)
    assert torch.equal(got, nttk.blind_rotate_nttf_ref(p, acc0, bk_lhs, a_hat))
