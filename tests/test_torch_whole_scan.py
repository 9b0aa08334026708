"""The rest of the whole-scan family of the port — Kernel B at key_limbs=3
('fused3', 'fusedb3'), Kernel E ('fusedp', 'fusedp3'), Kernel F ('fusedw',
'fusedwb') and Kernel G ('fusedc', 'fusedc3') — and the samples-per-CTA
picker, against the JAX package.

Every comparison is bit-exact (tolerance 0).  On the CPU the port's kernel
wrappers run their plain twins.  At ``nano`` each is held against its JAX
Pallas kernel in interpret mode, on a key planted with words whose low byte
is 0x80 (where truncating before or after the sign twist differs); each JAX
output is computed once at B=8 and sliced for B=3.  At ``test_insecure``
the exact impls are held against the JAX ``conv`` scan through
``blind_rotate``, and the truncated ones against the port's 'fused3' rows
and through decrypted NAND gates.  tests/test_torch_cuda.py holds each CUDA
kernel against its twin on the card.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_tpu as jtfhe
import tfhe_tpu.golden.model as g
import tfhe_tpu_torch as ttfhe
from tfhe_tpu.models import bootstrap as jboot
from tfhe_tpu.models import glwe as jglwe
from tfhe_tpu.models import lwe as jlwe
from tfhe_tpu.models import test_vector as jtv
from tfhe_tpu.models.keys import make_server_key as j_make_server_key
from tfhe_tpu.ops.decomposer import decompose_balanced_planes as j_balanced_planes
from tfhe_tpu.ops.pallas import blind_rotate_kernel as jbrk
from tfhe_tpu.ops.poly import ep_combine as j_ep_combine
from tfhe_tpu.ops.poly import ep_contract_matmul as j_ep_contract_matmul
from tfhe_tpu.ops.torus import switch_modulus as j_switch_modulus
from tfhe_tpu_torch.models import bootstrap as tboot
from tfhe_tpu_torch.models.keys import keys_from_numpy
from tfhe_tpu_torch.ops import poly
from tfhe_tpu_torch.ops.cuda import _build
from tfhe_tpu_torch.ops.cuda import blind_rotate_kernel as brk
from tfhe_tpu_torch.ops.decomposer import decompose_balanced_planes, decompose_signed_planes
from tfhe_tpu_torch.ops.poly import monomial_mul
from tfhe_tpu_torch.ops.torus import to_numpy_u32, to_torch_u32
from tfhe_tpu_torch.params import get_params as t_get_params

NANO_B = 8
BLOCK = brk.BLOCK  # the blocked tiling's width (csrc/mma_row.cuh:kBlock)
BITS_A = np.array([0, 0, 1, 1], dtype=np.uint32)
BITS_B = np.array([0, 1, 0, 1], dtype=np.uint32)

#: impl -> (JAX kernel, port wrapper, options both take)
VARIANTS = {
    "fused3": (jbrk.blind_rotate_fused, brk.blind_rotate_fused, {"key_limbs": 3}),
    "fusedb3": (jbrk.blind_rotate_fused, brk.blind_rotate_fused,
                {"key_limbs": 3, "balanced": True}),
    "fusedp": (jbrk.blind_rotate_fused_pipe, brk.blind_rotate_fused_pipe, {}),
    "fusedp3": (jbrk.blind_rotate_fused_pipe, brk.blind_rotate_fused_pipe, {"key_limbs": 3}),
    "fusedw": (jbrk.blind_rotate_fused_wide_pipe, brk.blind_rotate_fused_wide_pipe, {}),
    "fusedwb": (jbrk.blind_rotate_fused_wide_pipe, brk.blind_rotate_fused_wide_pipe,
                {"balanced": True}),
    "fusedc": (jbrk.blind_rotate_fused_cols, brk.blind_rotate_fused_cols, {}),
    "fusedc3": (jbrk.blind_rotate_fused_cols, brk.blind_rotate_fused_cols, {"key_limbs": 3}),
}


def rnd_u32(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


def gaussian_u32(rng, std, shape):
    return g.f64_to_torus(rng.normal(0.0, std, size=shape))


def plant_0x80(rng, words: np.ndarray) -> np.ndarray:
    """A copy of ``words`` with a quarter of them given the low byte 0x80,
    half of those then negated (the low byte of -w is 0x80 too)."""
    flat = words.copy().reshape(-1)
    idx = rng.choice(flat.size, size=flat.size // 4, replace=False)
    flat[idx] = (flat[idx] & np.uint32(0xFFFFFF00)) | np.uint32(0x80)
    flat[idx[::2]] = np.uint32(0) - flat[idx[::2]]
    return flat.reshape(words.shape)


# ---------------------------------------------------------------------------
# the truncated key
# ---------------------------------------------------------------------------


def test_truncation_follows_the_sign_twist():
    """key_limbs=3 drops the low balanced byte of the sign-twisted word
    w = +-g: the kept value is w - sext8(w & 0xFF).  Truncating g and then
    negating differs by 256 wherever the low byte is 0x80."""
    rng = np.random.default_rng(90)
    n = 8
    row = plant_0x80(rng, rnd_u32(rng, (1, 1, n)))
    scale = torch.tensor([1, 1 << 8, 1 << 16, 1 << 24]).view(1, 4, 1)  # limb weights

    def recombined(w):  # W[(m), (l, o)] -> sum_l limb_l << 8l, [m, o]
        return (w.to(torch.int64).reshape(n, 4, n) * scale).sum(1).numpy() % (1 << 32)

    kept = recombined(poly.bk_to_matmul_w(to_torch_u32(row), key_limbs=3))
    g32 = row[0, 0].astype(np.int64)
    m, o = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    twisted = np.where(m <= o, g32[(o - m) % n], -g32[(o - m) % n]) % (1 << 32)
    low = twisted & 0xFF
    model = twisted - np.where(low >= 128, low - 256, low)
    assert np.array_equal(kept, model % (1 << 32))
    low_g = g32 & 0xFF
    g_cut = g32 - np.where(low_g >= 128, low_g - 256, low_g)
    negate_after = np.where(m <= o, g_cut[(o - m) % n], -g_cut[(o - m) % n])
    assert not np.array_equal(model % (1 << 32), negate_after % (1 << 32))
    # the exact default keeps all four limbs
    assert np.array_equal(recombined(poly.bk_to_matmul_w(to_torch_u32(row))), twisted)


# ---------------------------------------------------------------------------
# Kernel B's tensor-core step, emulated fragment by fragment
# ---------------------------------------------------------------------------


def limb_plane_copies(g_row, base=0, bw=None):
    """The 16 staged copies of ``csrc/limb_planes.cuh:build_window`` for one
    key row g u32[N] and the window of 2*bw entries from ``base`` (the whole
    planes, ``build_planes``, by default), as bytes [limb l, shift s, word w,
    byte j] = P_l[(base + 4w + s + j) mod 2N], w < bw/2, P_l[x] =
    limb_l(ext[(-x) mod 2N]), ext = [g, -g]."""
    n = g_row.size
    bw = bw or n
    ext = np.concatenate([g_row, (np.uint32(0) - g_row).astype(np.uint32)])
    words = (ext + np.uint32(0x80808080)) ^ np.uint32(0x80808080)
    limbs = np.stack([((words >> np.uint32(8 * l)) & np.uint32(0xFF)).astype(np.uint8)
                      for l in range(4)]).view(np.int8)  # limb_l(ext[i])
    x = base + 4 * np.arange(bw // 2)[None, :, None] + np.arange(4)[:, None, None] + np.arange(4)
    return limbs[:, (-x) % (2 * n)]  # [4, 4, bw/2, 4]


@functools.lru_cache(maxsize=None)
def kernel_b_a_reads(n, blocked=False):
    """Where ``blind_rotate_kernel.cu:mma_row`` reads its A fragments, and
    which output each M row is, for a row (or, ``blocked``, a 512-wide block
    of the blocked tiling, where x0 gains 512 and no read needs the mask or
    the wrap copy: the window holds every entry the block reads) n wide.  A
    warp owns T = 4 tiles (2 at N=64) 32 outputs apart, from o_t =
    32T*(warp // 2) + 16*(warp % 2); row g of a tile is output o_t + 32a +
    8 + g, row g+8 output o_t + 32a + g.  Lane
    (g, t) reads copy x0 & 3, x0 = (4t - o_t - 8 - g) mod 2N; tile a at K
    step j takes the quad loaded at step j - a, words ((x0 >> 2) + 8(j - a))
    mod N/2 + 2i of the copy (its wrap copy past N/2), i = 0..3, as its
    registers a0..a3: rows g, g+8, g, g+8 at K offsets 4t, 4t, 16+4t, 16+4t
    (PTX m16n8k32 A fragment).  Returns the flat index into one limb's
    copies [4, N/2 + 8 words, 4 bytes] of each A entry [rows, N] and the
    output of each row, rows = (warp, tile, M row)."""
    tiles = 4 if n >= 128 else 2
    warps, steps = n // (16 * tiles), n // 32
    shape = (warps, tiles, 16, steps, 32)  # [warp, tile, row, K step, k]
    copy, word, byte = (np.zeros(shape, np.int64) for _ in range(3))
    wv, av, jv = np.ix_(np.arange(warps), np.arange(tiles), np.arange(steps))
    o_t = 32 * tiles * (wv // 2) + 16 * (wv % 2)
    for g in range(8):
        for t in range(4):
            x0 = (4 * t - o_t - 8 - g + (BLOCK if blocked else 0)) % (2 * n)
            base = ((x0 >> 2) + 8 * (jv - av)) % (n // 2)
            if blocked:  # the unmasked words w .. w+6 lie in the window
                assert np.array_equal(base, (x0 >> 2) + 8 * (jv - av)) and base.max() + 6 < n // 2
            for i, (row, k0) in enumerate(((g, 4 * t), (g + 8, 4 * t), (g, 16 + 4 * t),
                                           (g + 8, 16 + 4 * t))):
                for j in range(4):
                    copy[:, :, row, :, k0 + j] = np.broadcast_to(x0 & 3, base.shape)
                    word[:, :, row, :, k0 + j] = base + 2 * i
                    byte[:, :, row, :, k0 + j] = j
    rows = np.arange(16)
    out = (o_t[:, :, 0, None] + 32 * av[:, :, 0, None] + np.where(rows < 8, rows + 8, rows - 8))
    flat = (copy * (n // 2 + 8) + word) * 4 + byte
    return flat.reshape(warps * tiles * 16, n), out.reshape(-1)


def kernel_b_step(digits, words, spc, key_limbs, b_op=None):
    """One step's delta as Kernel B computes it, for the spc samples of one
    CTA: digits int8 [spc, R, N], key step u32 [R, C, N] -> (int64 limb sums
    [spc, C*4, N] with limb 0 left out at key_limbs=3, u32 delta [spc, C, N]).
    Each (r, c, l) is an mma.sync product A [N rows, N] x B [N, 8]: A read
    from the limb planes (with their wrap copy) as ``kernel_b_a_reads``
    says, B[k, n] = digit of sample n mod spc at k (the spare columns of
    spc < 8 repeat a sample; or ``b_op`` [8, R, N], as read from a staged
    digit block), and the accumulator fragment's c0..c3 of lane (g, t), rows
    g (c0, c1) and g+8 (c2, c3), samples 2t, 2t+1, stored at the rows'
    outputs for the samples < spc.  Above N = 512 each product runs block
    by block (``mma_row.cuh``): block (ob, kc) reads the window of 2*512
    entries from 512 (kc - ob - 1) mod 2N, its inputs 512 kc .. +512 and
    outputs 512 ob .. +512."""
    _, r_rows, n = digits.shape
    c_cols = words.shape[1]
    bw = min(n, BLOCK)
    blocks = n // bw
    flat, out = kernel_b_a_reads(bw, n > BLOCK)
    lmin = 4 - key_limbs
    if b_op is None:
        b_op = digits[np.arange(8) % spc]
    b_op = b_op.astype(np.float64)  # [8, R, N]
    # the (M row of every tile, sample) each lane's c0..c3 hold, samples < spc
    frag = [(g + 8 * (i >> 1), 2 * t + (i & 1)) for g in range(8) for t in range(4)
            for i in range(4) if 2 * t + (i & 1) < spc]
    rows = (np.arange(0, bw, 16)[:, None] + np.array([f[0] for f in frag])).reshape(-1)
    samples = np.tile(np.array([f[1] for f in frag]), bw // 16)
    sums = np.zeros((spc, c_cols * 4, n), np.int64)
    for r, c, ob, kc in itertools.product(range(r_rows), range(c_cols), range(blocks),
                                          range(blocks)):
        base = BLOCK * (kc - ob - 1) % (2 * n) if blocks > 1 else 0
        planes = limb_plane_copies(words[r, c], base, bw)
        planes = np.concatenate([planes, planes[:, :, :8]], axis=2)  # the wrap copy
        for l in range(lmin, 4):
            a_op = np.take(planes[l], flat).astype(np.float64)  # [bw rows, bw]
            d = (a_op @ b_op[:, r, kc * bw:(kc + 1) * bw].T).astype(np.int64)  # [bw rows, 8]
            np.add.at(sums[:, c * 4 + l, ob * bw:(ob + 1) * bw], (samples, out[rows]),
                      d[rows, samples])
    assert np.abs(sums).max() < 2**31  # exact in s32
    limb_w = np.array([1 << (8 * l) for l in range(4)], np.uint64)
    delta = (sums.reshape(spc, c_cols, 4, n).astype(np.uint64)
             * limb_w[None, None, :, None]).sum(2) & np.uint64(0xFFFFFFFF)
    return sums, delta.astype(np.uint32)


@pytest.mark.parametrize("name,spc,key", [
    *((name, spc, key) for name, spc in (("nano", 2), ("nano", 8), ("test_insecure", 8))
      for key in ("random", "low-0x80", "0x80")),
    ("test_insecure", 4, "random")])
def test_kernel_b_fragment_reads_match_twin_step(name, spc, key):
    """Kernel B's step read fragment by fragment (the diagonal walk of its
    window over the shifted limb planes, the digits as B, the accumulator
    layout) gives the twin's limb sums ``ep_contract_matmul`` and its delta
    ``ep_combine(...)`` bit for bit, at key_limbs 4 and 3, on a random key,
    one whose every low byte is 0x80 (the truncated key's hard case) and one
    whose every byte is 0x80."""
    p = t_get_params(name)
    k1, n = p.glwe_dimension + 1, p.degree
    r = k1 * p.pbs_decomposer.levels
    rng = np.random.default_rng(95)
    words = rnd_u32(rng, (r, k1, n))
    if key == "low-0x80":
        words = (words & np.uint32(0xFFFFFF00)) | np.uint32(0x80)
    elif key == "0x80":
        words = np.full((r, k1, n), 0x80808080, np.uint32)
    digits = rng.integers(-8, 17, size=(spc, r, n), dtype=np.int8)
    for key_limbs in (4, 3):
        sums, delta = kernel_b_step(digits, words, spc, key_limbs)
        want = poly.ep_contract_matmul(torch.from_numpy(digits), to_torch_u32(words), key_limbs)
        assert np.array_equal(sums, want.numpy())  # limb 0 is 0 in both at key_limbs=3
        assert np.array_equal(delta, to_numpy_u32(poly.ep_combine(want, k1)))


@pytest.mark.parametrize("spc,key", [(4, "random"), (2, "0x80"), (1, "low-0x80")])
def test_blocked_fragment_reads_match_twin_step(spc, key):
    """The blocked tiling at large_2048 (N=2048: 4 x 4 blocks of 512), read
    fragment by fragment: each block's A registers from the window of 2*512
    entries of its base (no read leaves the window's 256 words), the B
    operand of input chunk kc read from a staged [R][spc][N + 16] digit
    block at kc*128 words past the lane's row start (whose padding holds
    garbage), and each pass's outputs at offset 512 ob, give the twin's limb
    sums ``ep_contract_matmul`` and delta ``ep_combine`` bit for bit, at
    key_limbs 4 and 3, for the samples per CTA of Kernel B (4) and of
    Kernels E, F and G (2) at large_2048 and one, on a random key, one whose
    every byte is 0x80 and one whose every low byte is 0x80.  Two key rows
    of the step: the window reads do not depend on the row."""
    p = t_get_params("large_2048")
    k1, n = p.glwe_dimension + 1, p.degree
    r, blocks, drow = 2, n // BLOCK, n + 16
    rng = np.random.default_rng(97)
    words = rnd_u32(rng, (r, k1, n))
    if key == "low-0x80":
        words = (words & np.uint32(0xFFFFFF00)) | np.uint32(0x80)
    elif key == "0x80":
        words = np.full((r, k1, n), 0x80808080, np.uint32)
    digits = rng.integers(-8, 17, size=(spc, r, n), dtype=np.int8)
    block = rng.integers(-128, 128, size=r * spc * drow, dtype=np.int8)
    rv, bb, i = np.meshgrid(np.arange(r), np.arange(spc), np.arange(n), indexing="ij")
    block[(rv * spc + bb) * drow + i] = digits[bb, rv, i]
    b_op = np.stack([np.concatenate([b_operand_from_block(block, row, spc, n, kc, BLOCK)
                                     for kc in range(blocks)], axis=1) for row in range(r)],
                    axis=1)
    assert np.array_equal(b_op, digits[np.arange(8) % spc])
    for key_limbs in (4, 3):
        sums, delta = kernel_b_step(digits, words, spc, key_limbs, b_op)
        want = poly.ep_contract_matmul(torch.from_numpy(digits), to_torch_u32(words), key_limbs)
        assert np.array_equal(sums, want.numpy())
        assert np.array_equal(delta, to_numpy_u32(poly.ep_combine(want, k1)))


# ---------------------------------------------------------------------------
# Kernel G's cluster step and Kernel F's digit ring, emulated
# ---------------------------------------------------------------------------


def b_operand_from_block(block, row, spc, n, kc=0, bw=None):
    """The B operand [8 samples, bw] that ``mma_row.cuh:mma_row`` reads for
    input chunk kc (bw wide; the whole row by default) of digit row ``row``
    of a [rows][spc][N + 16] int8 block (flat): lane (g, t) starts at word
    (row*spc + g mod spc)*(N + 16)/4 + t (``lane_of``), kc*bw/4 more, and at
    K step j loads words 8j and 8j + 4 from there, the PTX m16n8k32 B
    fragment's bytes k = 32j + 4t .. +3 and 32j + 16 + 4t .. +3 of column g."""
    bw = bw or n
    out = np.zeros((8, bw), np.int8)
    for g in range(8):
        for t in range(4):
            word0 = (row * spc + g % spc) * (n + 16) // 4 + t + kc * bw // 4
            for j in range(bw // 32):
                for half in (0, 1):
                    at = 4 * (word0 + 8 * j + 4 * half)
                    k = 32 * j + 16 * half + 4 * t
                    out[g, k:k + 4] = block[at:at + 4]
    return out


@pytest.mark.parametrize("name,spc,key", [
    (name, spc, key) for name, spc in (("nano", 8), ("nano", 2), ("test_insecure", 8))
    for key in ("random", "low-0x80", "0x80")])
def test_kernel_g_cluster_step_matches_twin_column(name, spc, key):
    """Kernel G's step, emulated: each CTA q of the cluster writes its own
    poly's digit rows as ``cols_kernel.cu`` does (rotate_decompose at
    own + bb*drow + i, stride spc*drow: a [levels][spc][drow] block whose
    padding holds garbage), the gather lays the C blocks one after another
    into [R][spc][drow], and CTA p's fragment walk over that block for its
    one column p gives column p of the twin's limb sums
    (``ep_contract_matmul``) and delta (``ep_combine``) bit for bit, at
    key_limbs 4 and 3, on a random key, one whose every low byte is 0x80
    and one whose every byte is 0x80."""
    p = t_get_params(name)
    k1, n, levels = p.glwe_dimension + 1, p.degree, p.pbs_decomposer.levels
    r = k1 * levels
    drow = n + 16
    rng = np.random.default_rng(96)
    words = rnd_u32(rng, (r, k1, n))
    if key == "low-0x80":
        words = (words & np.uint32(0xFFFFFF00)) | np.uint32(0x80)
    elif key == "0x80":
        words = np.full((r, k1, n), 0x80808080, np.uint32)
    digits = rng.integers(-8, 17, size=(spc, r, n), dtype=np.int8)
    lv, bb, i = np.meshgrid(np.arange(levels), np.arange(spc), np.arange(n), indexing="ij")
    blocks = []
    for q in range(k1):  # CTA q's own rows, padding included
        block = rng.integers(-128, 128, size=levels * spc * drow, dtype=np.int8)
        block[lv * spc * drow + bb * drow + i] = digits[bb, q * levels + lv, i]
        blocks.append(block)
    gathered = np.concatenate(blocks)
    b_op = np.stack([b_operand_from_block(gathered, row, spc, n) for row in range(r)], axis=1)
    assert np.array_equal(b_op, digits[np.arange(8) % spc])
    for key_limbs in (4, 3):
        want = poly.ep_contract_matmul(torch.from_numpy(digits), to_torch_u32(words), key_limbs)
        want_delta = to_numpy_u32(poly.ep_combine(want, k1))
        for col in range(k1):  # the cluster's CTA col
            sums, delta = kernel_b_step(digits, words[:, col:col + 1], spc, key_limbs, b_op)
            assert np.array_equal(sums, want.numpy()[:, 4 * col:4 * col + 4])
            assert np.array_equal(delta[:, 0], want_delta[:, col])


def wide_pipe_schedule(c_cols, levels, steps, blocks=1):
    """Kernel F's digit ring as ``wide_pipe_kernel.cu`` runs it: a list of
    barrier intervals (what the CTA does between two barriers), each a list
    of events:
      ('build', step, poly, slot, lo, hi) - digits of poly at step into its
        slot, chunks lo .. hi-1 of the U = R*blocks^2 unit-sized chunks,
        reading accumulator plane poly;
      ('row', step, c, r, slot, ob, kc) - column c's mmas on input chunk kc
        of digit row r for output block ob (one unit; the whole row when
        blocks = 1), read from the slot of poly r // levels;
      ('pass', step, c, ob) - the pass's sums added to block ob of
        accumulator plane c; ('column', step, c) - column c is done.
    Poly p of step s sits in slot (s*C + p) mod (2C-1).  Step 0's polys are
    built before the loop; poly c-1 of step s+1 is built chunk u in unit u
    of column c; poly C-1 of step s+1 after column C-1, in an interval of
    its own."""
    rows = c_cols * levels
    units = rows * blocks * blocks

    def slot(step, p):
        return (step * c_cols + p) % (2 * c_cols - 1)

    intervals = [[("build", 0, p, slot(0, p), 0, units) for p in range(c_cols)]]
    for step in range(steps):
        last = step + 1 == steps
        for c, ob, r, kc in itertools.product(range(c_cols), range(blocks), range(rows),
                                              range(blocks)):
            uc = (ob * rows + r) * blocks + kc
            ev = [("row", step, c, r, slot(step, r // levels), ob, kc)]
            if not last and c > 0:
                ev.append(("build", step + 1, c - 1, slot(step + 1, c - 1), uc, uc + 1))
            if r == rows - 1 and kc == blocks - 1:
                ev.append(("pass", step, c, ob))
                if ob == blocks - 1:
                    ev.append(("column", step, c))
            intervals.append(ev)
        if not last:
            intervals.append([("build", step + 1, c_cols - 1, slot(step + 1, c_cols - 1), 0,
                               units)])
    return intervals


def check_wide_pipe_schedule(c_cols, blocks):
    """Over 3 steps: no interval both reads and writes a slot or both reads
    and updates an accumulator plane; a slot is never overwritten while its
    digits have a read to come; every column of every step reads all R rows
    of its own step's digits, each complete, in every (ob, kc) unit; and a
    poly's digits are built from its plane once that plane's column of the
    step is done."""
    levels, steps = 6, 3
    rows = c_cols * levels
    units = rows * blocks * blocks
    held = {}  # slot -> [(step, poly), chunks built]
    done = set()  # (step, c) columns whose sums are in their plane
    read = {}  # (step, c) -> units read
    for ev in wide_pipe_schedule(c_cols, levels, steps, blocks):
        written = {e[3] for e in ev if e[0] == "build"}
        assert not written & {e[4] for e in ev if e[0] == "row"}
        assert not ({e[2] for e in ev if e[0] == "build"}
                    & {e[2] for e in ev if e[0] == "pass"})
        for e in ev:
            if e[0] == "row":
                _, step, c, r, slot, ob, kc = e
                content, chunks = held[slot]
                assert content == (step, r // levels) and chunks == set(range(units))
                read.setdefault((step, c), set()).add((ob, r, kc))
            elif e[0] == "build":
                _, step, poly, slot, lo, hi = e
                # its plane holds step-1's sums of column poly: done, or step 0
                assert step == 0 or (step - 1, poly) in done
                if held.get(slot, [None])[0] != (step, poly):
                    old = held.get(slot, [None])[0]
                    # the old digits have no read to come: their step's
                    # last column is done
                    assert old is None or (old[0], c_cols - 1) in done
                    held[slot] = [(step, poly), set()]
                held[slot][1].update(range(lo, hi))
        done.update((e[1], e[2]) for e in ev if e[0] == "column")
    every = set(itertools.product(range(blocks), range(rows), range(blocks)))
    assert read == {(s, c): every for s in range(steps) for c in range(c_cols)}


@pytest.mark.parametrize("c_cols", [1, 2, 3])
def test_kernel_f_digit_ring_schedule(c_cols):
    """``check_wide_pipe_schedule`` at N <= 512: one unit per row."""
    check_wide_pipe_schedule(c_cols, 1)


@pytest.mark.parametrize("c_cols,blocks", [(1, 2), (2, 2), (2, 4), (3, 2)])
def test_kernel_f_blocked_digit_ring_schedule(c_cols, blocks):
    """``check_wide_pipe_schedule`` in the blocked tiling (N > 512): units
    (c, ob, r, kc), a poly's next digits in R*blocks^2 chunks."""
    check_wide_pipe_schedule(c_cols, blocks)


def replay_contraction(drow, bk_row, c, ob, kc, bw, key_limbs=4):
    """One unit of a column's sums: digit row drow [B, 1, N] (input chunk kc,
    bw wide) against key row bk_row [1, C, N] for output block ob of column
    c, as int32 limb sums [B, 4, bw]."""
    chunk = torch.zeros_like(drow)
    chunk[..., kc * bw:(kc + 1) * bw] = drow[..., kc * bw:(kc + 1) * bw]
    part = poly.ep_contract_matmul(chunk, bk_row, key_limbs)[:, 4 * c:4 * c + 4]
    return part[..., ob * bw:(ob + 1) * bw]


@pytest.mark.parametrize("balanced,blocks", [
    pytest.param(False, 1, id="False"), pytest.param(True, 1, id="True"),
    pytest.param(False, 2, id="False-blocks2")])
def test_kernel_f_digit_ring_replay_matches_twin(nano_case, balanced, blocks):
    """``wide_pipe_schedule`` run on the twin's step functions at nano (one
    CTA of 8 samples: each unit-chunk builds coefficients [u*chunk,
    (u+1)*chunk) of the 8*N, chunk = ceil(8*N / U)) equals
    ``blind_rotate_fused_wide_pipe_ref``; with blocks = 2 the nano row runs
    as 2 x 2 blocks of 32, as the blocked tiling runs its blocks of 512."""
    p, acc0_np, bk_np, a_hat_np, _ = nano_case
    dp = p.pbs_decomposer
    k1, n, levels = p.glwe_dimension + 1, p.degree, dp.levels
    rows = k1 * levels
    bw = n // blocks
    acc0, bk = to_torch_u32(acc0_np), to_torch_u32(bk_np)
    a_hat = torch.from_numpy(a_hat_np)
    b, steps = acc0.shape[0], bk.shape[0]
    decompose = decompose_balanced_planes if balanced else decompose_signed_planes
    chunk = -(-b * n // (rows * blocks * blocks))
    acc = acc0.clone()
    ring = torch.zeros((2 * k1 - 1, levels, b * n), dtype=torch.int8)
    sums = None
    for ev in wide_pipe_schedule(k1, levels, steps, blocks):
        for e in ev:
            if e[0] == "build":
                _, step, poly_, slot, lo, hi = e
                plane = acc[:, poly_]
                digits = decompose(monomial_mul(plane, a_hat[step]) - plane, dp)
                items = slice(lo * chunk, min(b * n, hi * chunk))
                ring[slot][:, items] = digits.reshape(levels, b * n)[:, items]
            elif e[0] == "row":
                _, step, c, r, slot, ob, kc = e
                drow = ring[slot][r % levels].reshape(b, 1, n)
                part = replay_contraction(drow, bk[step, r:r + 1], c, ob, kc, bw)
                sums = part if r == 0 and kc == 0 else sums + part
            elif e[0] == "pass":
                _, step, c, ob = e
                acc[:, c, ob * bw:(ob + 1) * bw] += poly.ep_combine(sums, 1)[:, 0]
    want = brk.blind_rotate_fused_wide_pipe_ref(p, acc0, bk, a_hat, balanced)
    assert torch.equal(acc, want)


# ---------------------------------------------------------------------------
# Kernel E's producer and consumer warps, replayed
# ---------------------------------------------------------------------------


def pipe_job_rows(job, c_cols, levels, plane_bufs, blocks=1):
    """``pipe_kernel.cu:job_rows``: the units lo..hi of the (step, c, ob, r,
    kc) sequence (rows when blocks = 1) in which the producers build digit
    job st*C + p (poly p of step st >= 1): from plane_bufs units after the
    last unit e of column p of step st-1 to the unit before the first that
    reads it (row p*levels of column 0 of step st), and at most a column's
    U = R*blocks^2 units after e."""
    units = c_cols * levels * blocks * blocks
    st, p = divmod(job, c_cols)
    e = ((st - 1) * c_cols + p) * units + units - 1
    f = st * c_cols * units + p * levels * blocks
    hi = min(f - 1, e + units)
    return min(e + plane_bufs, hi), hi


def pipe_schedule(c_cols, levels, steps, plane_bufs, blocks=1):
    """Kernel E's two roles as ``pipe_kernel.cu`` runs them: (prologue,
    producers, consumers), each a list of operations in program order:
      ('wait', barrier, parity) - until the barrier's phase of that parity
        has completed; ('arrive', barrier) - one arrival (each role counts as
        one party: every barrier waits for the whole of one role);
      ('plane', u, buf) - the producers build unit u's planes into a buffer
        (a row's when blocks = 1, a block's window otherwise);
      ('build', step, poly, slot, chunk, chunks) - digits of poly at step,
        chunk of chunks, into a ring slot, reading accumulator plane poly;
      ('row', step, c, r, buf, slot, ob, kc) - the consumers' mmas on input
        chunk kc of row r for output block ob of column c (one unit):
        planes from buf, digits from the slot of poly r // levels;
      ('pass', step, c, ob) - the pass's sums added to accumulator plane c;
      ('column', step, c) - column c is in accumulator plane c.
    Barriers: ('full', b), ('empty', b) per plane buffer and ('column', c).
    No barrier says a slot is filled: a poly's last chunk is built before
    the planes of the first unit that reads it.  Step 0's digits are the
    prologue's."""
    rows = c_cols * levels
    nslots, jobs = 2 * c_cols - 1, steps * c_cols
    total = steps * c_cols * rows * blocks * blocks
    prologue = [("build", 0, p, p, 0, 1) for p in range(c_cols)] if steps else []
    prod = []
    job = c_cols
    lo, hi = (pipe_job_rows(job, c_cols, levels, plane_bufs, blocks) if job < jobs
              else (0, -1))
    for u in range(total):
        b, use = u % plane_bufs, u // plane_bufs
        prod += [("wait", ("empty", b), (use & 1) ^ 1), ("plane", u, b), ("arrive", ("full", b))]
        if job < jobs and u >= lo:
            st, p = divmod(job, c_cols)
            if u == lo:
                prod.append(("wait", ("column", p), (st - 1) & 1))
            prod.append(("build", st, p, job % nslots, u - lo, hi - lo + 1))
            if u == hi:
                job += 1
                if job < jobs:
                    lo, hi = pipe_job_rows(job, c_cols, levels, plane_bufs, blocks)
    cons = []
    u = 0
    for step, c in itertools.product(range(steps), range(c_cols)):
        for ob in range(blocks):
            for r, kc in itertools.product(range(rows), range(blocks)):
                b, slot = u % plane_bufs, (step * c_cols + r // levels) % nslots
                cons += [("wait", ("full", b), (u // plane_bufs) & 1),
                         ("row", step, c, r, b, slot, ob, kc), ("arrive", ("empty", b))]
                u += 1
            cons.append(("pass", step, c, ob))
        cons += [("column", step, c), ("arrive", ("column", c))]
    return prologue, prod, cons


def run_pipe(schedule, policy):
    """Run the two roles of ``pipe_schedule`` over phase-parity barriers
    (a wait on parity P passes once the barrier's completed phases k have
    k mod 2 != P), choosing which role steps while both can: 'producers'
    or 'consumers' first, or at random from a seed.  Returns the
    operations in the order they ran; fails on a deadlock."""
    prologue, *roles = schedule
    done = {}  # barrier -> completed phases
    pos = [0, 0]
    order = list(prologue)
    rng = np.random.default_rng(policy) if isinstance(policy, int) else None

    def ready(who):
        if pos[who] == len(roles[who]):
            return False
        op = roles[who][pos[who]]
        return op[0] != "wait" or done.get(op[1], 0) % 2 != op[2]

    while pos[0] < len(roles[0]) or pos[1] < len(roles[1]):
        can = [who for who in (0, 1) if ready(who)]
        assert can, f"deadlock at producers {pos[0]}, consumers {pos[1]}"
        if rng is not None:
            who = can[rng.integers(len(can))]
        else:
            who = can[0] if policy == "producers" else can[-1]
        op = roles[who][pos[who]]
        pos[who] += 1
        if op[0] == "arrive":
            done[op[1]] = done.get(op[1], 0) + 1
        elif op[0] != "wait":
            order.append(op)
    return order


def check_pipe_schedule(c_cols, blocks, policies):
    """Over 3 steps, under each policy of ``run_pipe``: no plane buffer or
    digit slot is written while a read of its old content is still to
    come; every unit's mmas read their own unit's planes and the complete
    digits of their own step; poly p of step s+1 is built only after column
    p of step s is in its accumulator plane, and column p of step s+1 adds
    to that plane only after every chunk of it is built; every column of
    every step reads all R rows in every (ob, kc).  No interleaving
    deadlocks."""
    levels, steps, plane_bufs = 6, 3, 3
    rows = c_cols * levels
    schedule = pipe_schedule(c_cols, levels, steps, plane_bufs, blocks)
    every = set(itertools.product(range(blocks), range(rows), range(blocks)))
    per_poly = c_cols * levels * blocks * blocks  # units that read one poly's digits
    for policy in policies:
        planes = {}  # buffer -> unit whose planes it holds
        slots = {}  # slot -> [(step, poly), chunks built, chunks]
        reads = {}  # (step, poly) -> units read of its digits
        units_read = {}  # (step, c) -> (ob, r, kc) read
        done = set()  # (step, c) columns in their accumulator plane
        read = set()  # units whose mmas have run
        for op in run_pipe(schedule, policy):
            if op[0] == "plane":
                _, unit, buf = op
                assert buf not in planes or planes[buf] in read  # its old unit is read
                planes[buf] = unit
            elif op[0] == "build":
                _, st, p, slot, chunk, chunks = op
                assert st == 0 or (st - 1, p) in done  # its input is final
                assert (st, p) not in done  # and not yet updated again
                held = slots.get(slot)
                if held is None or held[0] != (st, p):
                    # the old digits have no read to come
                    assert held is None or reads.get(held[0], 0) == per_poly
                    slots[slot] = held = [(st, p), set(), chunks]
                held[1].add(chunk)
            elif op[0] == "row":
                _, st, c, r, buf, slot, ob, kc = op
                index = (((st * c_cols + c) * blocks + ob) * rows + r) * blocks + kc
                assert planes[buf] == index  # its own planes
                content, built, chunks = slots[slot]
                assert content == (st, r // levels) and built == set(range(chunks))
                read.add(index)
                reads[content] = reads.get(content, 0) + 1
                units_read.setdefault((st, c), set()).add((ob, r, kc))
            elif op[0] == "pass":
                _, st, c, ob = op
                content, built, chunks = slots[(st * c_cols + c) % (2 * c_cols - 1)]
                assert content == (st, c) and built == set(range(chunks))
            elif op[0] == "column":
                _, st, c = op
                assert units_read[st, c] == every
                done.add((st, c))
        assert units_read == {(s, c): every for s in range(steps) for c in range(c_cols)}
        assert len(done) == steps * c_cols


@pytest.mark.parametrize("c_cols", [1, 2, 3])
def test_kernel_e_pipe_schedule(c_cols):
    """``check_pipe_schedule`` at N <= 512 (one unit per row), with the
    producers as far ahead as the barriers let them, as far behind, and in
    20 random interleavings."""
    check_pipe_schedule(c_cols, 1, ("producers", "consumers", *range(20)))


@pytest.mark.parametrize("c_cols,blocks", [(1, 2), (2, 2), (2, 4), (3, 2)])
def test_kernel_e_blocked_pipe_schedule(c_cols, blocks):
    """``check_pipe_schedule`` in the blocked tiling (N > 512): units (c, ob,
    r, kc), the column barrier after a column's last pass, digit jobs
    spread over units; producers ahead, behind and 5 random
    interleavings."""
    check_pipe_schedule(c_cols, blocks, ("producers", "consumers", *range(5)))


@pytest.mark.parametrize("key_limbs,blocks", [
    pytest.param(4, 1, id="4"), pytest.param(3, 1, id="3"), pytest.param(4, 2, id="4-blocks2")])
def test_kernel_e_pipe_replay_matches_twin(nano_case, key_limbs, blocks):
    """``pipe_schedule`` run on the twin's step functions at nano (one CTA
    of 8 samples: chunk j of J builds coefficients [j*m, (j+1)*m) of the
    8*N, m = ceil(8N/J) rounded up to a multiple of 4, as the kernel's
    threads take 4 coefficients each), in a random interleaving of the two
    roles, equals ``blind_rotate_fused_pipe_ref``; with blocks = 2 the nano
    row runs as 2 x 2 blocks of 32."""
    p, acc0_np, bk_np, a_hat_np, _ = nano_case
    dp = p.pbs_decomposer
    k1, n, levels = p.glwe_dimension + 1, p.degree, dp.levels
    bw = n // blocks
    acc0, bk = to_torch_u32(acc0_np), to_torch_u32(bk_np)
    a_hat = torch.from_numpy(a_hat_np)
    b, steps = acc0.shape[0], bk.shape[0]
    acc = acc0.clone()
    ring = torch.zeros((2 * k1 - 1, levels, b * n), dtype=torch.int8)
    sums = None
    for op in run_pipe(pipe_schedule(k1, levels, steps, 3, blocks), 7):
        if op[0] == "build":
            _, step, poly_, slot, chunk, chunks = op
            plane = acc[:, poly_]
            digits = decompose_signed_planes(monomial_mul(plane, a_hat[step]) - plane, dp)
            size = -(-b * n // (4 * chunks)) * 4
            items = slice(chunk * size, min(b * n, (chunk + 1) * size))
            ring[slot][:, items] = digits.reshape(levels, b * n)[:, items]
        elif op[0] == "row":
            _, step, c, r, _, slot, ob, kc = op
            drow = ring[slot][r % levels].reshape(b, 1, n)
            part = replay_contraction(drow, bk[step, r:r + 1], c, ob, kc, bw, key_limbs)
            sums = part if r == 0 and kc == 0 else sums + part
        elif op[0] == "pass":
            _, step, c, ob = op
            acc[:, c, ob * bw:(ob + 1) * bw] += poly.ep_combine(sums, 1)[:, 0]
    want = brk.blind_rotate_fused_pipe_ref(p, acc0, bk, a_hat, key_limbs)
    assert torch.equal(acc, want)


# ---------------------------------------------------------------------------
# nano: each twin against its Pallas kernel in interpret mode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nano_case():
    """Seeded nano inputs at B=8 with a 0x80-planted key, and a cached call
    of each JAX kernel on them."""
    p = t_get_params("nano")
    k1, n = p.glwe_dimension + 1, p.degree
    rng = np.random.default_rng(91)
    acc0 = rnd_u32(rng, (NANO_B, k1, n))
    bk = plant_0x80(rng, rnd_u32(rng, (p.lwe_dimension, k1 * p.pbs_decomposer.levels, k1, n)))
    a_hat = rng.integers(0, 2 * n, size=(p.lwe_dimension, NANO_B), dtype=np.int32)

    @functools.lru_cache(maxsize=None)
    def jax_out(impl):
        jfn, _, options = VARIANTS[impl]
        return np.asarray(jfn(jtfhe.get_params("nano"), jnp.asarray(acc0), jnp.asarray(bk),
                              jnp.asarray(a_hat), interpret=True, **options), np.uint32)

    return p, acc0, bk, a_hat, jax_out


@pytest.mark.parametrize("batch", [NANO_B, 3])
@pytest.mark.parametrize("impl", list(VARIANTS))
def test_twin_matches_pallas_interpret_nano(nano_case, impl, batch):
    p, acc0, bk, a_hat, jax_out = nano_case
    _, fn, options = VARIANTS[impl]
    got = fn(p, to_torch_u32(acc0[:batch]), to_torch_u32(bk),
             torch.from_numpy(a_hat[:, :batch].copy()), **options)
    assert np.array_equal(to_numpy_u32(got), jax_out(impl)[:batch])


# ---------------------------------------------------------------------------
# test_insecure: through blind_rotate and the gates
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def insecure():
    """test_insecure keys from injected randomness, shared by both packages;
    mod-switched ciphertexts of 4 messages, the identity test vector, the
    JAX conv rotation of them, and the port's cached rotations by impl."""
    p = jtfhe.get_params("test_insecure")
    rng = np.random.default_rng(92)
    k, n_deg, n = p.glwe_dimension, p.degree, p.lwe_dimension
    rows = (k + 1) * p.pbs_decomposer.levels
    kn = k * n_deg
    lwe_sk = rng.integers(0, 2, size=n, dtype=np.uint32)
    glwe_sk = rng.integers(0, 2, size=(k, n_deg), dtype=np.uint32)
    jsk = j_make_server_key(
        p, lwe_sk, glwe_sk, rnd_u32(rng, (n, rows, k, n_deg)),
        gaussian_u32(rng, p.glwe_std_dev, (n, rows, n_deg)),
        rnd_u32(rng, (kn * p.ks_decomposer.levels, n)),
        gaussian_u32(rng, p.lwe_std_dev, (kn * p.ks_decomposer.levels,)))
    tp = t_get_params("test_insecure")
    tck, tsk = keys_from_numpy(tp, lwe_sk, glwe_sk, np.asarray(jsk.bk_u32),
                               np.asarray(jsk.ksk_u32), device="cpu")
    cts = np.asarray(jlwe.encrypt(lwe_sk, g.lwe_encode(np.arange(4, dtype=np.uint32), p),
                                  rnd_u32(rng, (4, n)),
                                  gaussian_u32(rng, p.lwe_std_dev, (4,))))
    approx = np.asarray(j_switch_modulus(jnp.asarray(cts), p.log_q, p.log_degree + 1))
    tv = jtv.identity_test_vector(p)
    want = np.asarray(jboot.blind_rotate(p, jnp.asarray(approx), jsk, jnp.asarray(tv),
                                         impl="conv"), np.uint32)

    @functools.lru_cache(maxsize=None)
    def rotate(impl):
        return tboot.blind_rotate(tp, to_torch_u32(approx), tsk, to_torch_u32(tv), impl=impl)

    return tp, tck, tsk, want, rotate


@pytest.mark.parametrize("impl", ["fusedp", "fusedw", "fusedc"])
def test_exact_impls_match_jax_conv(insecure, impl):
    *_, want, rotate = insecure
    assert np.array_equal(to_numpy_u32(rotate(impl)), want)


def test_fusedwb_matches_fusedb(insecure):
    """The balanced digits through Kernel F's twin and Kernel B's, whose
    twin tests/test_torch_kernels.py holds against the JAX balanced scan."""
    *_, want, rotate = insecure
    assert torch.equal(rotate("fusedwb"), rotate("fusedb"))
    assert not np.array_equal(to_numpy_u32(rotate("fusedwb")), want)  # other digits


@pytest.mark.parametrize("impl", ["fusedp3", "fusedc3"])
def test_truncated_impls_match_fused3(insecure, impl):
    *_, want, rotate = insecure
    assert torch.equal(rotate(impl), rotate("fused3"))
    assert not np.array_equal(to_numpy_u32(rotate("fused3")), want)  # the key is truncated


@pytest.mark.parametrize("impl", ["fused3", "fusedb3", "fusedp3", "fusedc3"])
def test_truncated_impls_decode_nand(insecure, impl):
    _, tck, tsk, *_ = insecure
    a = ttfhe.encrypt(tck, BITS_A, torch.Generator().manual_seed(1))
    b = ttfhe.encrypt(tck, BITS_B, torch.Generator().manual_seed(2))
    got = ttfhe.decrypt(tck, ttfhe.gates.nand(tsk, a, b, impl=impl))
    assert np.array_equal(to_numpy_u32(got), 1 - (BITS_A & BITS_B))


# ---------------------------------------------------------------------------
# large_2048 and large_4096: the twins against the JAX scans
# ---------------------------------------------------------------------------


def large_case(name, seed):
    """Seeded inputs at a large degree: 2 steps, B=3, a random key."""
    p = t_get_params(name)
    k1, n = p.glwe_dimension + 1, p.degree
    rng = np.random.default_rng(seed)
    acc0 = rnd_u32(rng, (3, k1, n))
    bk = rnd_u32(rng, (2, k1 * p.pbs_decomposer.levels, k1, n))
    a_hat = rng.integers(0, 2 * n, size=(2, 3), dtype=np.int32)
    return p, acc0, bk, a_hat


@pytest.mark.parametrize("name", ["large_2048", "large_4096"])
def test_twin_matches_jax_matmul_scan_at_large_degrees(name):
    """The carry-chain digits at N=2048 and 4096, where the kernels run in
    blocks: the port's wrapper (on the CPU its twin, the twin of 'fused',
    'fusedp', 'fusedw' and 'fusedc' alike) against the JAX package's
    ``rotate_chunk_xla(..., 'matmul')`` (its scan of the reference's step),
    bit for bit.  Pallas in interpret mode is too slow here."""
    p, acc0, bk, a_hat = large_case(name, 98)
    want = jboot.rotate_chunk_xla(jtfhe.get_params(name), jnp.asarray(acc0), jnp.asarray(bk),
                                  jnp.asarray(a_hat), "matmul")
    got = brk.blind_rotate_fused(p, to_torch_u32(acc0), to_torch_u32(bk),
                                 torch.from_numpy(a_hat))
    assert np.array_equal(to_numpy_u32(got), np.asarray(want, np.uint32))


def test_balanced_twin_matches_jax_scan_at_large_2048():
    """The balanced digits ('fusedb', 'fusedwb') at N=2048: the twin against
    a JAX scan of the closed-form decomposition
    (``tfhe_tpu/ops/decomposer.py:decompose_balanced_planes``) and the JAX
    matmul contraction, bit for bit."""
    p, acc0, bk, a_hat = large_case("large_2048", 99)
    jp = jtfhe.get_params("large_2048")
    k1, levels = jp.glwe_dimension + 1, jp.pbs_decomposer.levels

    @jax.jit
    def step(acc, bk_i, a_i):
        rot = jglwe.mul_monomial(acc, a_i)
        digs = jnp.moveaxis(j_balanced_planes(rot - acc, jp.pbs_decomposer), 0, -2)
        digs = digs.reshape(digs.shape[0], k1 * levels, jp.degree)
        return acc + j_ep_combine(j_ep_contract_matmul(digs, bk_i), k1)

    acc = jnp.asarray(acc0)
    for i in range(bk.shape[0]):
        acc = step(acc, jnp.asarray(bk[i]), jnp.asarray(a_hat[i]))
    got = brk.blind_rotate_fused(p, to_torch_u32(acc0), to_torch_u32(bk),
                                 torch.from_numpy(a_hat), balanced=True)
    assert np.array_equal(to_numpy_u32(got), np.asarray(acc, np.uint32))


def test_valid_impls_mirror_jax():
    """The JAX package's impls, in its order, less the interpret modes (the
    CPU twins play their role); 'conv' resolves to itself."""
    want = tuple(i for i in jboot.VALID_IMPLS if not i.endswith("_interpret"))
    assert tboot.VALID_IMPLS == want
    assert tboot.resolve_impl("conv", "cpu") == "conv"
    with pytest.raises(ValueError):
        tboot.resolve_impl("conv_interpret", "cpu")
    for impl in ("fused3", "fusedb3", "fusedp", "fusedp3", "fusedw", "fusedwb", "fusedc",
                 "fusedc3"):
        assert tboot.resolve_impl(impl, "cpu") == impl
    assert tboot.resolve_impl("auto", torch.device("cuda")) == "pallas"


# ---------------------------------------------------------------------------
# the shared-memory budget: samples per CTA
# ---------------------------------------------------------------------------

H100_OPTIN = 232448  # bytes of opt-in shared memory per block on an H100


@pytest.mark.parametrize("kind,bytes_at_8,on_h100", [
    ("fused", 163104, 8), ("pipe", 230808, 8), ("wide_pipe", 213824, 8), ("cols", 181024, 8)])
def test_samples_per_cta_on_h100_budget(kind, bytes_at_8, on_h100):
    """At default_128 every kernel keeps 8 samples per CTA, so each tensor-core
    kernel fills the mma's 8 sample columns: F's ring of 2C-1 = 5 digit
    slots fits beside its accumulators, plane buffers and raw rows, where
    2C = 6 would not (239,168 bytes).  Kernel E keeps the same ring beside
    three plane buffers: 49,152 bytes of accumulators (8*3*512 words),
    3 * 16,896 of planes (16 copies of 264 words), 2 * 2,048 of raw rows,
    5 * 25,344 of digits (6 rows of 8 * 528 bytes), 8 * 11 of mbarriers
    (full and empty for 3 buffers, 2 raw rows, 3 columns) and 64 of
    exponents: 230,808 of the 232,448."""
    p = t_get_params("default_128")
    assert brk.smem_bytes(kind, p, 8) == bytes_at_8
    pick = _build.pick_samples_per_cta(lambda s: brk.smem_bytes(kind, p, s), H100_OPTIN)
    assert pick == on_h100
    if kind == "wide_pipe":  # one more slot would not fit
        assert bytes_at_8 + 6 * 8 * (512 + 16) == 239168 > H100_OPTIN
    if kind == "pipe":
        assert bytes_at_8 == 49152 + 3 * 16896 + 2 * 2048 + 5 * 25344 + 8 * 11 + 64


def test_samples_per_cta_under_smaller_budgets():
    p = t_get_params("default_128")

    def pick(kind, budget):
        return _build.pick_samples_per_cta(lambda s: brk.smem_bytes(kind, p, s), budget)

    assert pick("fused", 100_000) == 2  # 4 samples need 100,496 bytes
    assert pick("fused", brk.smem_bytes("fused", p, 4)) == 4
    assert pick("fused", brk.smem_bytes("fused", p, 2)) == 2  # the bound is inclusive
    assert pick("fused", brk.smem_bytes("fused", p, 2) - 1) == 1
    assert pick("pipe", 48 * 1024) is None  # one sample needs 76,864 bytes
    assert pick("wide_pipe", 48 * 1024) is None  # not even one sample
    assert pick("cols", 0) is None
    # the choices are tried in the order given
    assert _build.pick_samples_per_cta(lambda s: 10 * s, 35, choices=(1, 2, 4)) == 1
    assert _build.pick_samples_per_cta(lambda s: 10 * s, 35) == 2


#: the H100's plans at the large degrees: kind -> (samples per CTA, bytes)
LARGE_PLANS = {
    "large_2048": {"fused": (4, 214800), "pipe": (2, 174240), "wide_pipe": (2, 157264),
                   "cols": (2, 165640)},
    "large_4096": {"fused": (2, 230792), "pipe": (1, 190328), "wide_pipe": (1, 173352),
                   "cols": (1, 181636)}}


def test_samples_per_cta_at_larger_degrees():
    """N=2048 and 4096, where Kernels B, E, F and G run the circulant in
    512 x 512 blocks: their plans on the H100's budget, each with one
    512-wide window of planes per plane buffer (16 copies of 264 words,
    16,896 bytes) beside whole raw key rows, and the next sample count over
    the budget.  Kernel B at large_2048 with 4 samples: 65,536 bytes of
    accumulators (4*2*2048 words), 2 * 16,896 of planes, 2 * 8,192 of raw
    rows, 12 * 4 * 2,064 of digits, 16 of exponents.  Each wrapper takes the
    degree: with meta tensors it gets as far as the device check, and
    launches nothing."""
    assert LARGE_PLANS["large_2048"]["fused"][1] == (4 * 4 * 2 * 2048 + 2 * 16896 + 2 * 8192
                                                     + 12 * 4 * 2064 + 16)
    kernels = (brk.KERNEL, brk.PIPE_KERNEL, brk.WIDE_PIPE_KERNEL, brk.COLS_KERNEL)
    before = [k.launches for k in kernels]
    for name, picks in LARGE_PLANS.items():
        p = t_get_params(name)
        for kind, (spc, nbytes) in picks.items():
            assert _build.pick_samples_per_cta(lambda s: brk.smem_bytes(kind, p, s),
                                               H100_OPTIN) == spc
            assert brk.smem_bytes(kind, p, spc) == nbytes
            assert brk.smem_bytes(kind, p, 2 * spc) > H100_OPTIN
        k1, n = p.glwe_dimension + 1, p.degree
        meta = (torch.empty((1, k1, n), dtype=torch.int32, device="meta"),
                torch.empty((1, k1 * p.pbs_decomposer.levels, k1, n), dtype=torch.int32,
                            device="meta"),
                torch.empty((1, 1), dtype=torch.int32, device="meta"))
        for fn in (brk.blind_rotate_fused, brk.blind_rotate_fused_pipe,
                   brk.blind_rotate_fused_wide_pipe, brk.blind_rotate_fused_cols):
            with pytest.raises(ValueError, match="CPU or CUDA"):
                fn(p, *meta)
    assert [k.launches for k in kernels] == before


def test_wrappers_refuse_degrees_outside_64_to_4096():
    """N=32 and N=8192 raise ValueError before anything else, on any device."""
    p = t_get_params("nano")
    levels = p.pbs_decomposer.levels
    for n in (32, 8192):
        meta = (torch.empty((1, 2, n), dtype=torch.int32, device="meta"),
                torch.empty((1, 2 * levels, 2, n), dtype=torch.int32, device="meta"),
                torch.empty((1, 1), dtype=torch.int32, device="meta"))
        for fn in (brk.blind_rotate_fused, brk.blind_rotate_fused_pipe,
                   brk.blind_rotate_fused_wide_pipe, brk.blind_rotate_fused_cols):
            with pytest.raises(ValueError, match="from 64 to 4096"):
                fn(p, *meta)


# ---------------------------------------------------------------------------
# wrappers: what they refuse
# ---------------------------------------------------------------------------


def test_wrappers_refuse_other_key_widths_and_devices(nano_case):
    p, acc0, bk, a_hat, _ = nano_case
    args = (p, to_torch_u32(acc0), to_torch_u32(bk), torch.from_numpy(a_hat))
    for fn in (brk.blind_rotate_fused, brk.blind_rotate_fused_pipe, brk.blind_rotate_fused_cols):
        with pytest.raises(ValueError, match="key_limbs"):
            fn(*args, key_limbs=2)
    meta = tuple(t.to("meta") for t in args[1:])
    for fn in (brk.blind_rotate_fused_pipe, brk.blind_rotate_fused_wide_pipe,
               brk.blind_rotate_fused_cols):
        with pytest.raises(ValueError, match="CPU or CUDA"):
            fn(p, *meta)
    kernels = (brk.KERNEL, brk.PIPE_KERNEL, brk.WIDE_PIPE_KERNEL, brk.COLS_KERNEL)
    assert all(k.launches == 0 for k in kernels)
    with pytest.raises(ValueError, match="unknown whole-scan kernel"):
        brk.smem_bytes("wide", p, 1)
