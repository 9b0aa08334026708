"""The batch-major external-product tier of the port against the JAX package:
Kernel H's twin (``ops/cuda/ep_kernel.py:ep_contract_ref``), the rest of
the ``ops/poly.py`` contraction family, ``models/ggsw.external_product`` /
``cmux`` with both impls, the ``conv`` blind-rotation scan and
``rotate_chunk``.

Every comparison is bit-exact (tolerance 0: all arithmetic is integer), on
inputs made with numpy from a seed.  Raw int32 limb sums are compared only
within one convention: Kernel H, ``ep_contract_pallas`` and
``ep_contract_matmul`` twist the sign onto the key word, ``ep_contract_conv``
onto the digits; the two agree after ``ep_combine``.
tests/test_torch_cuda.py holds Kernel H against its twin on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_tpu as jtfhe
import tfhe_tpu.golden.model as g
import tfhe_tpu_torch as ttfhe
from tfhe_tpu.models import bootstrap as jboot
from tfhe_tpu.models import ggsw as jggsw
from tfhe_tpu.models.keys import make_server_key as j_make_server_key
from tfhe_tpu.ops import poly as jpoly
from tfhe_tpu.ops.pallas.ep_kernel import ep_contract_pallas
from tfhe_tpu_torch.models import bootstrap as tboot
from tfhe_tpu_torch.models import ggsw as tggsw
from tfhe_tpu_torch.models.keys import keys_from_numpy, with_ntt_key
from tfhe_tpu_torch.ops import poly as tpoly
from tfhe_tpu_torch.ops.cuda import ep_kernel as epk
from tfhe_tpu_torch.ops.torus import to_numpy_u32, to_torch_u32
from tfhe_tpu_torch.params import get_params as t_get_params

EDGE = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1, 0x80808080, 0x7F7F7F7F,
                 0xFFFFFF80, 0x00000080, 0x7FFFFFFF], dtype=np.uint32)


def rnd_u32(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


def gaussian_u32(rng, std, shape):
    return g.f64_to_torus(rng.normal(0.0, std, size=shape))


def same(torch_u32, jax_u32) -> bool:
    return np.array_equal(to_numpy_u32(torch_u32), np.asarray(jax_u32, np.uint32))


def same_int(torch_t, jax_t) -> bool:
    return np.array_equal(torch_t.numpy(), np.asarray(jax_t))


def ep_inputs(name, batch, key, seed, digits="chain"):
    """Batch-major digits int8[B, R, N] (the carry chain's range, or the full
    int8 range with digits='full') and one GGSW u32[R, C, N]: random, every
    byte 0x80 ('0x80'), or random with a quarter of the words given 0x80
    bytes and the edge values planted ('planted')."""
    p = t_get_params(name)
    k1, n = p.glwe_dimension + 1, p.degree
    r = k1 * p.pbs_decomposer.levels
    rng = np.random.default_rng(seed)
    lo, hi = (-8, 17) if digits == "chain" else (-128, 128)
    digits = rng.integers(lo, hi, size=(batch, r, n), dtype=np.int8)
    if key == "0x80":
        return digits, np.full((r, k1, n), 0x80808080, np.uint32)
    words = rnd_u32(rng, (r, k1, n))
    if key == "planted":
        flat = words.reshape(-1)
        idx = rng.choice(flat.size, size=flat.size // 4, replace=False)
        flat[idx] = (flat[idx] & np.uint32(0x00FF00FF)) | np.uint32(0x80008000)
        flat[idx[::3]] = np.uint32(0x80808080)
        flat[:EDGE.size] = EDGE
    return digits, words


# ---------------------------------------------------------------------------
# Kernel H: ep_contract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,key,digit_range", [
    pytest.param("nano", "random", "chain", id="nano-random"),
    pytest.param("nano", "0x80", "chain", id="nano-0x80"),
    pytest.param("test_insecure", "planted", "chain", id="test_insecure-planted"),
    pytest.param("test_insecure", "planted", "full", id="test_insecure-planted-full")])
def test_ep_contract_twin_matches_pallas_interpret(name, key, digit_range):
    digits, words = ep_inputs(name, 5, key, seed=61, digits=digit_range)
    want = np.asarray(ep_contract_pallas(jnp.asarray(digits), jnp.asarray(words),
                                         interpret=True))
    ref = epk.ep_contract_ref(torch.from_numpy(digits), to_torch_u32(words))
    assert np.array_equal(ref.numpy(), want)
    # on CPU tensors the wrapper is the twin
    assert torch.equal(epk.ep_contract(torch.from_numpy(digits), to_torch_u32(words)), ref)


def test_ep_contract_refuses_other_devices():
    digits, words = ep_inputs("nano", 2, "random", seed=62)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        epk.ep_contract(torch.from_numpy(digits).to("meta"), to_torch_u32(words).to("meta"))
    assert epk.BATCH_KERNEL.launches == 0


def shifted_limb_planes(g_row):
    """The 16 staged copies of ``csrc/ep_contract.cuh:build_planes`` for one
    key row g u32[N], as bytes [limb l, shift s, word w, byte j] =
    P_l[(4w + s + j) mod 2N], P_l[x] = limb_l(ext[(-x) mod 2N]), ext = [g, -g]."""
    n = g_row.size
    ext = np.concatenate([g_row, (np.uint32(0) - g_row).astype(np.uint32)])
    words = (ext + np.uint32(0x80808080)) ^ np.uint32(0x80808080)
    limbs = np.stack([((words >> np.uint32(8 * l)) & np.uint32(0xFF)).astype(np.uint8)
                      for l in range(4)]).view(np.int8)  # limb_l(ext[i])
    x = 4 * np.arange(n // 2)[None, :, None] + np.arange(4)[:, None, None] + np.arange(4)
    return limbs[:, (-x) % (2 * n)]  # [4, 4, N/2, 4]


def test_circulant_from_shifted_planes_matches_twin():
    """The layout identity Kernels A and H rely on: the B-fragment register
    of k = m0 + 4t + j (j = 0..3) at n = o is word (x >> 2) of copy (x & 3),
    x = (m0 + 4t - o) mod 2N, so entry (m, o) of the circulant is byte m % 4
    of that word.  Reading W so, four bytes at a time, the sums equal the
    twin (test_insecure, full-range digits, B=5)."""
    digits, words = ep_inputs("test_insecure", 5, "planted", seed=71, digits="full")
    b, r, n = digits.shape
    c = words.shape[1]
    quad = np.arange(n // 4)[:, None]
    x = (4 * quad - np.arange(n)[None, :]) % (2 * n)  # [N/4, N]: one word per 4 rows m
    want = epk.ep_contract_ref(torch.from_numpy(digits), to_torch_u32(words)).numpy()
    got = np.zeros((b, c * 4, n), np.int64)
    for ri in range(r):
        for ci in range(c):
            planes = shifted_limb_planes(words[ri, ci])
            for l in range(4):
                word_bytes = planes[l][x & 3, x >> 2]  # [N/4, N, 4]: bytes j of the B word
                w_mat = word_bytes.transpose(0, 2, 1).reshape(n, n).astype(np.int64)
                got[:, ci * 4 + l] += digits[:, ri].astype(np.int64) @ w_mat
    assert np.array_equal(got, want)


def plan_coverage(plan, b, r, c, n):
    """How often the plan's launch covers each (sample, limb), each (column,
    output) and each row, following ``ep_contract.cuh:contract``'s indexing:
    grid (split, C * N/to, ceil(B/bm)); CTA q of a cluster sums rows
    [q*rows_per, ...) and stores the partial rows rho = l*bm + bb with
    rho = q, q + split, ....  An output (b, c, l, o) is stored
    samples[b, l] * cols[c, o] times, with rows[r] of each row in it."""
    bm, to, split, rows_per = (plan[k] for k in ("samples_per_cta", "outputs_per_cta", "split",
                                                 "rows_per_split"))
    samples, cols, rows = np.zeros((b, 4), int), np.zeros((c, n), int), np.zeros(r, int)
    for z in range(-(-b // bm)):
        for q in range(split):
            for rho in range(q, 4 * bm, split):
                l, bb = divmod(rho, bm)
                if z * bm + bb < b:
                    samples[z * bm + bb, l] += 1
    for y in range(c * (n // to)):
        ci, o0 = divmod(y, n // to)
        cols[ci, o0 * to:o0 * to + to] += 1
    for q in range(split):
        rows[q * rows_per:min(r, q * rows_per + rows_per)] += 1
    return samples, cols, rows


@pytest.mark.parametrize("batch", [1, 7, 64, 1024])
@pytest.mark.parametrize("name,row_mult", [("nano", 1), ("test_insecure", 1), ("default_128", 1),
                                           ("default_128", 3), ("large_2048", 1),
                                           ("large_4096", 1)])
def test_ep_plan_covers_every_output_and_row_once(name, row_mult, batch):
    """The plan of Kernels A and H on an H100 (132 SMs, 232,448 bytes of
    opt-in shared memory): every output stored once, every row summed into
    it once, the shared memory within the budget, and the card filled at
    default_128, B=64."""
    p = t_get_params(name)
    c, n = p.glwe_dimension + 1, p.degree
    r = c * p.pbs_decomposer.levels * row_mult
    plan = epk.ep_plan(batch, r, c, n, 132, 232448)
    assert plan["smem_bytes"] <= 232448
    assert plan["smem_bytes"] == epk.smem_bytes(n, plan["samples_per_cta"], plan["warps"],
                                                plan["digit_buffers"])
    assert 1 <= plan["split"] <= epk.MAX_SPLIT
    assert plan["samples_per_cta"] in (16, 32) and n % plan["outputs_per_cta"] == 0
    for counts in plan_coverage(plan, batch, r, c, n):
        assert (counts == 1).all()
    tiles = -(-batch // plan["samples_per_cta"]) * (n // plan["outputs_per_cta"]) * c
    assert plan["ctas"] == plan["split"] * tiles
    if name == "default_128" and batch == 64:
        assert plan["ctas"] >= 132


def test_ep_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="power of two"):
        epk.ep_plan(4, 18, 3, 16, 132, 232448)  # the kernels take N >= 32
    with pytest.raises(ValueError, match="power of two"):
        epk.ep_plan(4, 18, 3, 96, 132, 232448)
    with pytest.raises(ValueError, match="shared memory"):
        epk.ep_plan(4, 12, 2, 4096, 132, 100_000)  # one 16-sample CTA needs more


# ---------------------------------------------------------------------------
# ops/poly.py: the rest of the contraction family
# ---------------------------------------------------------------------------


def test_monomial_mul_custom_mod_matches():
    rng = np.random.default_rng(63)
    n = 64
    poly = rnd_u32(rng, (3, n))
    poly[0, :EDGE.size] = EDGE
    t = to_torch_u32(poly)
    for log_mod in (7, 11, 31, 32):
        for e in (-5, 0, 1, n, n + 3, 2 * n - 1):
            assert same(tpoly.monomial_mul_custom_mod(t, e, log_mod),
                        jpoly.monomial_mul_custom_mod(poly, e, log_mod)), (e, log_mod)
    per_sample = np.array([-70, n + 3, 2 * n + 1], dtype=np.int32)
    assert same(tpoly.monomial_mul_custom_mod(t, torch.from_numpy(per_sample), 11),
                jpoly.monomial_mul_custom_mod(poly, per_sample, 11))


@pytest.mark.parametrize("n", [8, 64, 512])
def test_poly_mul_u32_matches(n):
    rng = np.random.default_rng(64 + n)
    a = rnd_u32(rng, (n,))
    b = rnd_u32(rng, (n,))
    a[: min(n, EDGE.size)] = EDGE[:n]
    b[-min(n, EDGE.size):] = EDGE[:n]
    assert same(tpoly.poly_mul_u32(to_torch_u32(a), to_torch_u32(b)), jpoly.poly_mul_u32(a, b))
    assert np.array_equal(to_numpy_u32(tpoly.poly_mul_u32(to_torch_u32(a), to_torch_u32(b))),
                          g.poly_mul(a, b))


@pytest.mark.parametrize("name", ["nano", "test_insecure"])
def test_conv_formulation_matches(name):
    digits, words = ep_inputs(name, 3, "planted", seed=65)
    t_words = to_torch_u32(words)
    assert same_int(tpoly.negacyclic_extend(torch.from_numpy(digits)),
                    jpoly.negacyclic_extend(digits))
    limbs = np.random.default_rng(66).integers(-128, 128, size=(2,) + words.shape + (4,),
                                               dtype=np.int8)
    assert same_int(tpoly.bk_u32_limbs_to_ocin(torch.from_numpy(limbs)),
                    jpoly.bk_u32_limbs_to_ocin(limbs))
    kernel_t = tpoly.bk_to_conv_kernel(t_words)
    kernel_j = jpoly.bk_to_conv_kernel(words)
    assert same_int(kernel_t, kernel_j)
    raw_t = tpoly.ep_contract_conv(torch.from_numpy(digits), kernel_t)
    raw_j = jpoly.ep_contract_conv(digits, kernel_j)
    assert same_int(raw_t, raw_j)
    # another convention than the Toeplitz form, the same u32 after the combine
    k1 = words.shape[1]
    matmul_t = tpoly.ep_contract_matmul(torch.from_numpy(digits), t_words)
    assert not torch.equal(raw_t, matmul_t)
    assert torch.equal(tpoly.ep_combine(raw_t, k1), tpoly.ep_combine(matmul_t, k1))


@pytest.mark.parametrize("name", ["nano", "test_insecure"])
def test_matmul_cols_match(name):
    """The column shards against JAX's, with ``o_start`` an int and a 0-d
    tensor, and against the matching columns of the whole contraction."""
    digits, words = ep_inputs(name, 3, "planted", seed=67)
    t_words = to_torch_u32(words)
    n = words.shape[-1]
    whole = tpoly.ep_contract_matmul(torch.from_numpy(digits), t_words)
    for o_start, n_cols in ((0, 8), (n // 2, 16), (n - 16, 16)):
        want_t = jpoly.sign_toeplitz_u32_cols(words[:2], o_start, n_cols)
        want_w = jpoly.bk_to_matmul_w_cols(words, o_start, n_cols)
        want = jpoly.ep_contract_matmul_cols(digits, words, o_start, n_cols)
        for o_t in (o_start, torch.tensor(o_start)):
            assert same(tpoly.sign_toeplitz_u32_cols(t_words[:2], o_t, n_cols), want_t)
            assert same_int(tpoly.bk_to_matmul_w_cols(t_words, o_t, n_cols), want_w)
            raw = tpoly.ep_contract_matmul_cols(torch.from_numpy(digits), t_words, o_t, n_cols)
            assert same_int(raw, want)
            assert torch.equal(raw, whole[..., o_start:o_start + n_cols])


# ---------------------------------------------------------------------------
# models: external product, CMUX, the conv scan and rotate_chunk
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def insecure():
    """test_insecure server keys from injected randomness, shared by both
    packages (the port's with the NTT key form too)."""
    p = jtfhe.get_params("test_insecure")
    rng = np.random.default_rng(2026)
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
    tp = ttfhe.get_params("test_insecure")
    _, tsk = keys_from_numpy(tp, lwe_sk, glwe_sk, np.asarray(jsk.bk_u32),
                             np.asarray(jsk.ksk_u32), device="cpu")
    return p, jsk, tp, with_ntt_key(tsk)


@pytest.mark.parametrize("impl", ["conv", "matmul"])
def test_external_product_and_cmux_match_jax(insecure, impl):
    p, jsk, tp, tsk = insecure
    rng = np.random.default_rng(68)
    ct0 = rnd_u32(rng, (2, 2, p.glwe_dimension + 1, p.degree))  # two leading dims
    ct1 = rnd_u32(rng, ct0.shape)
    for i in (0, p.lwe_dimension - 1):
        ours = tggsw.external_product(tsk.bk_u32[i], to_torch_u32(ct0), tp, impl=impl)
        assert same(ours, jggsw.external_product(jsk.bk_u32[i], ct0, p, impl=impl)), i
    ours = tggsw.cmux(tsk.bk_u32[1], to_torch_u32(ct0), to_torch_u32(ct1), tp, impl=impl)
    assert same(ours, jggsw.cmux(jsk.bk_u32[1], ct0, ct1, p, impl=impl))
    with pytest.raises(ValueError, match="unknown impl"):
        tggsw.external_product(tsk.bk_u32[0], to_torch_u32(ct0), tp, impl=impl + "_interpret")


def test_conv_blind_rotation_matches_jax_conv(insecure):
    """The 'conv' scan through ``blind_rotate`` against JAX's 'conv' and the
    port's 'matmul' (tests/test_torch_pbs.py holds its PBS and NAND gates
    against JAX's 'conv')."""
    p, jsk, tp, tsk = insecure
    rng = np.random.default_rng(69)
    approx = rng.integers(0, 2 * p.degree, size=(3, p.lwe_dimension + 1), dtype=np.uint32)
    tv = rnd_u32(rng, (p.degree,))
    want = jboot.blind_rotate(p, jnp.asarray(approx), jsk, jnp.asarray(tv), impl="conv")
    got = tboot.blind_rotate(tp, to_torch_u32(approx), tsk, to_torch_u32(tv), impl="conv")
    assert same(got, want)
    assert torch.equal(
        got, tboot.blind_rotate(tp, to_torch_u32(approx), tsk, to_torch_u32(tv), impl="matmul"))


@pytest.fixture(scope="module")
def jax_rotation(insecure):
    """acc0 and exponents at test_insecure, and JAX's whole 'conv' rotation."""
    p, jsk, *_ = insecure
    rng = np.random.default_rng(70)
    acc0 = rnd_u32(rng, (3, p.glwe_dimension + 1, p.degree))
    a_hat = rng.integers(0, 2 * p.degree, size=(p.lwe_dimension, 3), dtype=np.int32)
    want = jboot.rotate_chunk(p, jnp.asarray(acc0), jsk.bk_conv, jnp.asarray(a_hat), "conv")
    return acc0, a_hat, np.asarray(want)


@pytest.mark.parametrize("impl", ["matmul", "conv", "pallas", "ntt"])
def test_rotate_chunk_in_two_chunks_matches_one_rotation(insecure, jax_rotation, impl):
    """Two chunks of steps equal JAX's whole 'conv' rotation; each impl
    reads its own key form."""
    _, _, tp, tsk = insecure
    acc0, a_hat, want = jax_rotation
    key = {"matmul": tsk.bk_u32, "conv": tsk.bk_u32, "pallas": tsk.bk_lm,
           "ntt": tsk.bk_ntt}[impl]
    a_t = torch.from_numpy(a_hat)
    half = tboot.rotate_chunk(tp, to_torch_u32(acc0), key[:2], a_t[:2], impl)
    assert same(tboot.rotate_chunk(tp, half, key[2:], a_t[2:], impl), want)


def test_rotate_chunk_refuses_other_impls(insecure):
    p, _, tp, tsk = insecure
    acc0 = torch.zeros((1, p.glwe_dimension + 1, p.degree), dtype=torch.int32)
    a_hat = torch.zeros((1, 1), dtype=torch.int32)
    for impl in ("fused", "conv_interpret", "auto"):
        with pytest.raises(ValueError, match="rotate_chunk"):
            tboot.rotate_chunk(tp, acc0, tsk.bk_u32[:1], a_hat, impl)
