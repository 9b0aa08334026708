"""The CUDA kernels of tfhe_tpu_torch against their plain twins, on the card.

Every case needs a CUDA device and skips without one.  The file imports
neither JAX nor tfhe_tpu, so it also runs on a machine without JAX:

    python -m pytest tests/test_torch_cuda.py -q -o addopts= --noconftest

(``--noconftest`` skips tests/conftest.py, which imports JAX.)
"""

import ctypes
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tfhe_tpu_torch.ops import ntt
from tfhe_tpu_torch.ops.cuda import _build
from tfhe_tpu_torch.ops.cuda import blind_rotate_kernel as brk
from tfhe_tpu_torch.ops.cuda import ep_kernel as epk
from tfhe_tpu_torch.ops.cuda import latency_kernel as latk
from tfhe_tpu_torch.ops.cuda import ntt_kernel as nttk
from tfhe_tpu_torch.ops.torus import to_torch_u32
from tfhe_tpu_torch.params import DecomposerParams, get_params


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def rnd_u32(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


@pytest.mark.cuda
@pytest.mark.parametrize("name,batch", [("nano", 1), ("nano", 8), ("test_insecure", 64)])
def test_ep_kernel_matches_twin_on_card(cuda_device, name, batch):
    p = get_params(name)
    k1, n = p.glwe_dimension + 1, p.degree
    r = k1 * p.pbs_decomposer.levels
    rng = np.random.default_rng(40 + batch)
    d = torch.from_numpy(rng.integers(-8, 17, size=(r, batch, n), dtype=np.int8)).to(cuda_device)
    g = to_torch_u32(rnd_u32(rng, (r, k1, n)), cuda_device)
    before = epk.KERNEL.launches
    got = epk.ep_contract_rbn(d, g)
    torch.cuda.synchronize()
    assert epk.KERNEL.launches == before + 1
    assert torch.equal(got, epk.ep_contract_rbn_ref(d, g))


def ep_batch_inputs(name, batch, key, seed):
    """Batch-major digits and one random GGSW on the card; ``key='0x80'``
    gives every byte of the GGSW the value 0x80 (where negating after the
    limb split would be wrong)."""
    p = get_params(name)
    k1, n = p.glwe_dimension + 1, p.degree
    r = k1 * p.pbs_decomposer.levels
    rng = np.random.default_rng(seed)
    d = torch.from_numpy(rng.integers(-8, 17, size=(batch, r, n), dtype=np.int8)).to("cuda")
    words = (np.full((r, k1, n), 0x80808080, np.uint32) if key == "0x80"
             else rnd_u32(rng, (r, k1, n)))
    return d, to_torch_u32(words, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,batch,key", [
    ("nano", 1, "random"), ("nano", 7, "random"), ("test_insecure", 64, "random"),
    ("nano", 7, "0x80"), ("test_insecure", 7, "0x80")])
def test_ep_batch_kernel_matches_twin_on_card(cuda_device, name, batch, key):
    """Kernel H against its twin, one launch each."""
    d, g = ep_batch_inputs(name, batch, key, seed=45 + batch)
    before = epk.BATCH_KERNEL.launches
    got = epk.ep_contract(d, g)
    torch.cuda.synchronize()
    assert epk.BATCH_KERNEL.launches == before + 1
    assert torch.equal(got, epk.ep_contract_ref(d, g))


def launch_with_plan(kernel, d, g, out, r, b, c, n, plan):
    """Call a contraction kernel's C entry point with a hand-made plan
    (bm, warps, split, rows_per, nbuf), past the wrapper's own checks."""
    info = (ctypes.c_int * 2)()
    kernel.launch(_build.ptr(d), _build.ptr(g), _build.ptr(out), r, b, c, n, *plan, info,
                  _build.stream_of(out))


@pytest.mark.cuda
def test_ep_batch_kernel_refuses_unsupported_shapes_on_card(cuda_device):
    """N=12 is not a power of two, N=4 and N=16 are below 32: the wrapper
    raises before any launch, and Kernel H's C entry point, given such a
    shape or a plan it does not take, returns cudaErrorInvalidValue; no
    launch is counted."""
    rng = np.random.default_rng(46)
    before = epk.BATCH_KERNEL.launches
    for n in (12, 4, 16):
        d = torch.from_numpy(rng.integers(-8, 17, size=(3, 2, n), dtype=np.int8)).to(cuda_device)
        g = to_torch_u32(rnd_u32(rng, (2, 2, n)), cuda_device)
        with pytest.raises(ValueError, match="power of two"):
            epk.ep_contract(d, g)
        out = torch.empty((3, 8, n), dtype=torch.int32, device=cuda_device)
        with pytest.raises(RuntimeError, match="invalid argument"):
            launch_with_plan(epk.BATCH_KERNEL, d, g, out, 2, 3, 2, n, (16, 2, 1, 2, 1))
    d, g = ep_batch_inputs("nano", 3, "random", seed=46)
    out = torch.empty((3, 8, 64), dtype=torch.int32, device=cuda_device)
    for plan in ((8, 4, 1, 12, 2),    # 8 samples per CTA
                 (16, 1, 1, 12, 2),   # 1 warp
                 (64, 4, 1, 12, 2),   # 64 samples per CTA
                 (16, 4, 3, 2, 2),    # 3 splits of 2 rows leave rows 6..11 out
                 (16, 4, 12, 1, 2),   # a cluster of 12 CTAs
                 (16, 8, 1, 12, 2),   # 8 warps are 128 outputs, N is 64
                 (16, 4, 1, 12, 3)):  # 3 digit buffers
        with pytest.raises(RuntimeError, match="invalid argument"):
            launch_with_plan(epk.BATCH_KERNEL, d, g, out, 12, 3, 2, 64, plan)
    assert epk.BATCH_KERNEL.launches == before


def ep_edge_inputs(name, batch, seed, layout, key="random", row_mult=1):
    """Full-range int8 digits (-128..127) in Kernel A's ('rbn') or Kernel
    H's ('batch') layout, and R' = row_mult * R key rows: random, or every
    byte 0x80 ('0x80')."""
    p = get_params(name)
    k1, n = p.glwe_dimension + 1, p.degree
    r = k1 * p.pbs_decomposer.levels * row_mult
    rng = np.random.default_rng(seed)
    shape = (r, batch, n) if layout == "rbn" else (batch, r, n)
    d = torch.from_numpy(rng.integers(-128, 128, size=shape, dtype=np.int8)).to("cuda")
    words = (np.full((r, k1, n), 0x80808080, np.uint32) if key == "0x80"
             else rnd_u32(rng, (r, k1, n)))
    return d, to_torch_u32(words, "cuda")


#: the contraction kernels by layout: (wrapper, twin, kernel)
EP_KERNELS = {"rbn": (epk.ep_contract_rbn, epk.ep_contract_rbn_ref, epk.KERNEL),
              "batch": (epk.ep_contract, epk.ep_contract_ref, epk.BATCH_KERNEL)}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["rbn", "batch"], ids=["A", "H"])
@pytest.mark.parametrize("name,batch,key,row_mult", [
    ("test_insecure", 1, "random", 1), ("test_insecure", 7, "random", 1),
    ("test_insecure", 17, "random", 1), ("test_insecure", 64, "random", 1),
    ("test_insecure", 65, "random", 1), ("test_insecure", 1024, "random", 1),
    ("test_insecure", 64, "random", 3), ("large_2048", 3, "random", 1),
    ("large_4096", 3, "random", 1), ("test_insecure", 7, "0x80", 1), ("nano", 5, "0x80", 3)])
def test_ep_kernels_match_twins_at_the_edges_on_card(cuda_device, layout, name, batch, key,
                                                     row_mult):
    """Kernels A and H equal their twins on full-range digits: partial and
    several M tiles (B = 1, 7, 17, 64, 65, 1024), the bmmp scan's 3R rows,
    large_2048 (C=2, N=2048), large_4096 (N=4096, where the plan has one
    digit buffer) and the all-0x80 key, one launch each."""
    fn, twin, kernel = EP_KERNELS[layout]
    d, g = ep_edge_inputs(name, batch, 140 + batch, layout, key, row_mult)
    before = kernel.launches
    got = fn(d, g)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    plan = epk.last_plan[kernel.symbol]
    assert plan["smem_bytes"] == epk.smem_bytes(g.shape[-1], plan["samples_per_cta"],
                                                plan["warps"], plan["digit_buffers"])
    assert plan["digit_buffers"] == (1 if name == "large_4096" else 2)
    assert torch.equal(got, twin(d, g))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["rbn", "batch"], ids=["A", "H"])
@pytest.mark.parametrize("sms,split", [(1, 1), (10_000, 8)], ids=["no-split", "split"])
def test_ep_kernels_match_twins_with_and_without_a_row_split_on_card(
        cuda_device, monkeypatch, layout, sms, split):
    """A card of 1 SM gives a plan with no row split, one of 10,000 SMs the
    largest split: 8 CTAs per cluster over the 3R = 54 rows, 7 rows each and
    5 in the last; both equal the twin at default_128's shape, B=64."""
    fn, twin, kernel = EP_KERNELS[layout]
    monkeypatch.setattr(epk, "sm_count", lambda device: sms)
    epk._plan_on.cache_clear()
    try:
        d, g = ep_edge_inputs("test_insecure", 64, 150 + sms % 7, layout, row_mult=3)
        got = fn(d, g)
        torch.cuda.synchronize()
        assert epk.last_plan[kernel.symbol]["split"] == split
        assert torch.equal(got, twin(d, g))
    finally:
        epk._plan_on.cache_clear()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["rbn", "batch"], ids=["A", "H"])
@pytest.mark.parametrize("bm", [16, 32])
def test_ep_kernels_match_twins_with_one_digit_buffer_on_card(cuda_device, layout, bm):
    """The plan parts that default_128 never picks: one digit buffer (what
    ep_plan gives at large_4096, where two do not fit) and 2 warps per CTA
    (N=32), here at test_insecure, B=40, rows split 3 ways."""
    fn, twin, kernel = EP_KERNELS[layout]
    d, g = ep_edge_inputs("test_insecure", 40, 160 + bm, layout)
    want = twin(d, g)
    r, c, n = g.shape
    out = torch.empty_like(want)
    launch_with_plan(kernel, d, g, out, r, 40, c, n, (bm, 2, 3, r // 3, 1))
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["rbn", "batch"], ids=["A", "H"])
def test_ep_kernels_launch_on_a_second_card(cuda_device, layout):
    """The shared-memory attribute is set per card: after a launch on the
    first card, a launch at default_128's shape (52,736 bytes, above the
    48 KB default) on the second runs there and equals the twin."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    fn, twin, kernel = EP_KERNELS[layout]
    d, g = ep_edge_inputs("default_128", 64, 170, layout)
    want = twin(d, g)
    assert torch.equal(fn(d, g), want)
    assert epk.last_plan[kernel.symbol]["smem_bytes"] > 48 * 1024
    second = torch.device("cuda", 1)
    before = kernel.launches
    got = fn(d.to(second), g.to(second))
    torch.cuda.synchronize(second)
    assert kernel.launches == before + 1
    assert got.device == second
    assert torch.equal(got.to(want.device), want)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["rbn", "batch"], ids=["A", "H"])
@pytest.mark.parametrize("model", [2, 3, 6])
def test_ep_kernels_match_twins_at_a_model_shard_of_the_rows_on_card(cuda_device, layout,
                                                                     model):
    """The row counts a model-sharded gate gives Kernels A and H at
    default_128: R = 18 / model = 9, 6, 3 rows, B=64, on full-range digits
    (whatever split and rows per split ``ep_plan`` picks for them)."""
    fn, twin, kernel = EP_KERNELS[layout]
    d, g = ep_edge_inputs("default_128", 64, 180 + model, layout)
    r = g.shape[0] // model
    d = (d[:r] if layout == "rbn" else d[:, :r]).contiguous()
    g = g[:r].contiguous()
    before = kernel.launches
    got = fn(d, g)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert epk.last_plan[kernel.symbol]["split"] * epk.last_plan[kernel.symbol][
        "rows_per_split"] >= r
    assert torch.equal(got, twin(d, g))


@pytest.mark.cuda
def test_every_parallel_mode_at_world_2_over_nccl_on_two_cards(cuda_device, tmp_path):
    """Every sharded and pipelined mode on two NCCL ranks, one card each, at
    test_insecure: each output equals the one-device 'conv' gate and each
    rank's recorded collectives (their sizes and calls) equal the traffic
    model."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    import tfhe_tpu_torch as tfhe
    from tfhe_tpu_torch.ops.torus import to_numpy_u32
    from tfhe_tpu_torch.parallel._testing import World
    from tfhe_tpu_torch.parallel.traffic import expected_calls, expected_collectives

    p = get_params("test_insecure")
    ck, sk = tfhe.keygen(p, 5, device="cpu")
    rng = np.random.default_rng(181)
    bits = rng.integers(0, 2, size=(2, 2, 4))
    q0 = np.stack([to_numpy_u32(tfhe.encrypt(ck, bits[0, i], 60 + i)) for i in range(2)])
    q1 = np.stack([to_numpy_u32(tfhe.encrypt(ck, bits[1, i], 70 + i)) for i in range(2)])
    modes = {  # name -> (kind, mesh, impl, traffic mode)
        "dp": ("sharded", [2, 1], "conv", "dp"), "dp_fusedp": ("sharded", [2, 1], "fusedp", "dp"),
        "tp_pallas": ("sharded", [1, 2], "pallas", "tp"),
        "tp_conv": ("sharded", [1, 2], "conv", "tp"),
        "coeffs": ("sharded", [1, 2], "coeffs", "coeffs"),
        "ntt": ("sharded", [1, 2], "ntt", "ntt"), "host": ("sharded", [1, 1, 2], "conv", "tp"),
        "pp_conv": ("pipeline", [1, 2], "conv", "pp"),
        "pp_pallas": ("pipeline", [1, 2], "pallas", "pp")}
    inputs = dict(lwe_sk=to_numpy_u32(ck.lwe_sk), glwe_sk=to_numpy_u32(ck.glwe_sk),
                  bk_u32=to_numpy_u32(sk.bk_u32), ksk_u32=to_numpy_u32(sk.ksk_u32),
                  ct0=q0[0], ct1=q1[0])
    for name in ("pp_conv", "pp_pallas"):
        inputs[f"q0_{name}"], inputs[f"q1_{name}"] = q0, q1
    cases = [dict(kind=kind, name=name, shape=shape, impl=impl)
             for name, (kind, shape, impl, _) in modes.items()]
    res = World(dict(world=2, backend="nccl", device="cuda:rank", params="test_insecure",
                     cases=cases), tmp_path, inputs).wait(600)
    want = to_numpy_u32(tfhe.gates.nand(sk, q0.reshape(8, -1), q1.reshape(8, -1),
                                        impl="conv")).reshape(q0.shape)
    for name, (kind, shape, _, mode) in modes.items():
        pipeline = kind == "pipeline"
        assert np.array_equal(res["outputs"][name], want if pipeline else want[0]), name
        local = 4 // int(np.prod(shape[:-1]))
        model = expected_collectives(p, mode, local, 2 if pipeline else 0)
        calls = expected_calls(p, mode, local, 2 if pipeline else 0, shape[-1] if pipeline else 1)
        for rank in res["ranks"]:
            assert {k: set(v) for k, v in rank[name]["payloads"].items()} == model, name
            assert {k: {int(b): c for b, c in v.items()}
                    for k, v in rank[name]["calls"].items()} == calls, name


def second_card_cases():
    """wrapper name -> (kernel, a function of the device giving the call)."""
    p = get_params("test_insecure")

    def whole_scan(fn, **options):
        def call(dev):
            acc0, bk, a_hat = whole_scan_inputs(p, 9, 175, "cpu", steps=2)
            return lambda: fn(p, acc0.to(dev), bk.to(dev), a_hat.to(dev), **options)
        return call

    def latency(dev):
        acc0, bk_lat, a_vhat = latency_inputs(p, 1, 3, seed=176)
        return lambda: latk.blind_rotate_latency(p, acc0.to(dev), bk_lat.to(dev), a_vhat.to(dev))

    def nttf(dev):
        acc0, bk_lhs, a_hat = nttf_inputs(p, 9, 177, "cpu", steps=2)
        return lambda: nttk.blind_rotate_nttf(p, acc0.to(dev), bk_lhs.to(dev), a_hat.to(dev))

    return {"B": (brk.KERNEL, whole_scan(brk.blind_rotate_fused, balanced=True)),
            "E": (brk.PIPE_KERNEL, whole_scan(brk.blind_rotate_fused_pipe)),
            "F": (brk.WIDE_PIPE_KERNEL, whole_scan(brk.blind_rotate_fused_wide_pipe)),
            "G": (brk.COLS_KERNEL, whole_scan(brk.blind_rotate_fused_cols)),
            "C": (latk.KERNEL, latency), "D": (nttk.KERNEL, nttf)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["B", "E", "F", "G", "C", "D"])
def test_whole_scan_kernels_launch_on_a_second_card(cuda_device, name):
    """Kernels B-G, C and D launch on their tensors' card: after a launch on
    the first card (shared memory above the 48 KB default), the same call on
    the second card's tensors, with the first card current, runs there and
    gives the first card's bits."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    kernel, case = second_card_cases()[name]
    want = case(cuda_device)()
    second = torch.device("cuda", 1)
    before = kernel.launches
    with torch.cuda.device(0):
        got = case(second)()
    torch.cuda.synchronize(second)
    assert kernel.launches == before + 1
    assert got.device == second
    assert torch.equal(got.to(want.device), want)


@pytest.mark.cuda
def test_external_product_conv_launches_kernel_h_on_card(cuda_device, monkeypatch):
    """'conv' on CUDA tensors goes through Kernel H, never the twin, and
    equals 'matmul' (the plain reference) bit for bit."""
    from tfhe_tpu_torch.models import ggsw

    p = get_params("test_insecure")
    rng = np.random.default_rng(47)
    k1, n = p.glwe_dimension + 1, p.degree
    g = to_torch_u32(rnd_u32(rng, (k1 * p.pbs_decomposer.levels, k1, n)), cuda_device)
    c0, c1 = (to_torch_u32(rnd_u32(rng, (33, k1, n)), cuda_device) for _ in range(2))
    want = ggsw.cmux(g, c0, c1, p, impl="matmul")
    monkeypatch.setattr(epk, "ep_contract_ref", lambda *a: pytest.fail("the twin ran"))
    before = epk.BATCH_KERNEL.launches
    got = ggsw.cmux(g, c0, c1, p, impl="conv")
    torch.cuda.synchronize()
    assert epk.BATCH_KERNEL.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_conv_scan_launches_kernel_h_per_step_on_card(cuda_device):
    """The 'conv' blind rotation launches Kernel H once per step and equals
    the 'matmul' scan."""
    from tfhe_tpu_torch.models import bootstrap

    p = get_params("test_insecure")
    rng = np.random.default_rng(48)
    k1, n = p.glwe_dimension + 1, p.degree
    acc0 = to_torch_u32(rnd_u32(rng, (5, k1, n)), cuda_device)
    bk = to_torch_u32(rnd_u32(rng, (p.lwe_dimension, k1 * p.pbs_decomposer.levels, k1, n)),
                      cuda_device)
    a_hat = torch.from_numpy(
        rng.integers(0, 2 * n, size=(p.lwe_dimension, 5), dtype=np.int32)).to(cuda_device)
    before = (epk.BATCH_KERNEL.launches, epk.KERNEL.launches)
    got = bootstrap.rotate_chunk(p, acc0, bk, a_hat, "conv")
    torch.cuda.synchronize()
    assert (epk.BATCH_KERNEL.launches, epk.KERNEL.launches) == (
        before[0] + p.lwe_dimension, before[1])
    assert torch.equal(got, bootstrap.rotate_chunk(p, acc0, bk, a_hat, "matmul"))


@pytest.mark.cuda
@pytest.mark.parametrize("balanced", [False, True], ids=["fused", "fusedb"])
@pytest.mark.parametrize("name,batch", [("nano", 3), ("test_insecure", 7)])
def test_blind_rotate_kernel_matches_twin_on_card(cuda_device, name, batch, balanced):
    p = get_params(name)
    k1, n = p.glwe_dimension + 1, p.degree
    rng = np.random.default_rng(50 + batch)
    acc0 = to_torch_u32(rnd_u32(rng, (batch, k1, n)), cuda_device)
    bk = to_torch_u32(rnd_u32(rng, (p.lwe_dimension, k1 * p.pbs_decomposer.levels, k1, n)),
                      cuda_device)
    a_hat = torch.from_numpy(
        rng.integers(0, 2 * n, size=(p.lwe_dimension, batch), dtype=np.int32)).to(cuda_device)
    before = brk.KERNEL.launches
    got = brk.blind_rotate_fused(p, acc0, bk, a_hat, balanced=balanced)
    torch.cuda.synchronize()
    assert brk.KERNEL.launches == before + 1
    assert torch.equal(got, brk.blind_rotate_fused_ref(p, acc0, bk, a_hat, balanced=balanced))


def kernel_b_key(rng, shape, key):
    """A random key, one whose every byte is 0x80, or one whose every low
    byte is 0x80 (the truncated key's hard case)."""
    words = rnd_u32(rng, shape)
    if key == "0x80":
        words[:] = 0x80808080
    elif key == "low-0x80":
        words = (words & np.uint32(0xFFFFFF00)) | np.uint32(0x80)
    return words


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["random", "0x80", "low-0x80"])
@pytest.mark.parametrize("batch", [1, 7, 8, 9, 64, 1024])
def test_blind_rotate_kernel_matches_twin_at_every_batch_on_card(cuda_device, batch, key):
    """Kernel B against its twin over 3 steps at test_insecure, in all four
    modes (fused, fusedb, fused3, fusedb3), one launch each: a part-filled
    CTA (B = 1, 7, 9), whole ones (8, 64) and the main path's batch."""
    p = get_params("test_insecure")
    k1, n = p.glwe_dimension + 1, p.degree
    rng = np.random.default_rng(70 + batch)
    bk = to_torch_u32(kernel_b_key(rng, (3, k1 * p.pbs_decomposer.levels, k1, n), key),
                      cuda_device)
    acc0 = to_torch_u32(rnd_u32(rng, (batch, k1, n)), cuda_device)
    a_hat = torch.from_numpy(rng.integers(0, 2 * n, size=(3, batch), dtype=np.int32)).to(
        cuda_device)
    for balanced in (False, True):
        for key_limbs in (4, 3):
            before = brk.KERNEL.launches
            got = brk.blind_rotate_fused(p, acc0, bk, a_hat, balanced, key_limbs)
            torch.cuda.synchronize()
            assert brk.KERNEL.launches == before + 1
            assert brk.last_plan["blind_rotate_fused"]["samples_per_cta"] == 8
            assert torch.equal(got, brk.blind_rotate_fused_ref(p, acc0, bk, a_hat, balanced,
                                                               key_limbs))


@pytest.mark.cuda
def test_kernels_refuse_unsupported_shapes_on_card(cuda_device):
    """The C entry points check the shapes their thread tiles allow, and the
    wrappers raise on the refusal without counting a launch."""
    p = get_params("nano")
    rng = np.random.default_rng(60)
    before = epk.KERNEL.launches
    for n in (12, 16):  # not a power of two; below 32
        d = torch.from_numpy(rng.integers(-8, 17, size=(2, 1, n), dtype=np.int8)).to(cuda_device)
        g = to_torch_u32(rnd_u32(rng, (2, 2, n)), cuda_device)
        with pytest.raises(ValueError, match="power of two"):
            epk.ep_contract_rbn(d, g)
        out = torch.empty((2, 4, 1, n), dtype=torch.int32, device=cuda_device)
        with pytest.raises(RuntimeError, match="invalid argument"):
            launch_with_plan(epk.KERNEL, d, g, out, 2, 1, 2, n, (16, 2, 1, 2, 1))
    assert epk.KERNEL.launches == before
    # Kernel B takes N a power of two from 64 to 4096 (8 warps of 4
    # 16-output tiles, in blocks of 512 above 512), any C: not N=32, N=96 or
    # N=8192, which its wrapper refuses and its C entry point too
    before = brk.KERNEL.launches
    for k1, n in ((2, 32), (2, 96), (2, 8192)):
        acc0 = to_torch_u32(rnd_u32(rng, (1, k1, n)), cuda_device)
        bk = to_torch_u32(rnd_u32(rng, (1, k1 * p.pbs_decomposer.levels, k1, n)), cuda_device)
        a_hat = torch.zeros((1, 1), dtype=torch.int32, device=cuda_device)
        with pytest.raises(ValueError, match="from 64 to 4096"):
            brk.blind_rotate_fused(p, acc0, bk, a_hat)
        dp, info = p.pbs_decomposer, (ctypes.c_int * 5)()
        with pytest.raises(RuntimeError, match="invalid argument"):
            brk.KERNEL.launch(_build.ptr(acc0), _build.ptr(bk), _build.ptr(a_hat),
                              _build.ptr(torch.empty_like(acc0)), 1, 1, k1, n, dp.levels,
                              dp.log_base, dp.ignored_bits, 0, 0, 4, 1, info,
                              _build.stream_of(acc0))
    # a key that is not 16-byte aligned (Kernel B copies it in 16-byte pieces)
    k1, n = 2, 64
    shape = (1, k1 * p.pbs_decomposer.levels, k1, n)
    flat = torch.zeros(int(np.prod(shape)) + 1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte aligned"):
        brk.blind_rotate_fused(p, to_torch_u32(rnd_u32(rng, (1, k1, n)), cuda_device),
                               flat[1:].view(shape), torch.zeros((1, 1), dtype=torch.int32,
                                                                 device=cuda_device))
    assert brk.KERNEL.launches == before


def latency_inputs(p, variants, batch, seed, steps=None, kind="random"):
    """Random acc0, key operand and exponents for Kernel C on the card.
    kind='worst': every key byte -128 (the largest int8 products) and an
    accumulator that step 0 rotates by N in every variant (rot - acc =
    -2*acc = 0xF8F8F800), whose carry-chain digits are -8 and the +B anomaly
    16 in turn (the largest digits)."""
    k1, n = p.glwe_dimension + 1, p.degree
    steps = steps or p.lwe_dimension
    rng = np.random.default_rng(seed)
    width = 4 * latk.n_groups(p, variants) * n
    acc0 = to_torch_u32(rnd_u32(rng, (batch, k1, n)), "cuda")
    bk_lat = torch.from_numpy(
        rng.integers(-128, 128, size=(steps, k1 * 4, width), dtype=np.int8)).to("cuda")
    a_vhat = torch.from_numpy(
        rng.integers(0, 2 * n, size=(steps, variants, batch), dtype=np.int32)).to("cuda")
    if kind == "worst":
        bk_lat = torch.full_like(bk_lat, -128)
        acc0 = to_torch_u32(np.full((batch, k1, n), 0x83838400, np.uint32), "cuda")
        a_vhat[0] = n
    return acc0, bk_lat, a_vhat


@pytest.mark.cuda
@pytest.mark.parametrize("name,variants,batch", [
    ("nano", 1, 1), ("nano", 1, 8), ("test_insecure", 1, 3),
    ("nano", 3, 4), ("test_insecure", 3, 3)])
def test_latency_kernel_matches_twin_on_card(cuda_device, name, variants, batch):
    p = get_params(name)
    acc0, bk_lat, a_vhat = latency_inputs(p, variants, batch, seed=70 + batch)
    before = latk.KERNEL.launches
    got = latk.blind_rotate_latency(p, acc0, bk_lat, a_vhat)
    torch.cuda.synchronize()
    assert latk.KERNEL.launches == before + 1
    assert latk.last_plan["cluster"] >= 1
    assert torch.equal(got, latk.blind_rotate_latency_ref(p, acc0, bk_lat, a_vhat))


@pytest.mark.cuda
def test_latency_kernel_refuses_unsupported_shapes_on_card(cuda_device):
    """N=12 is not a power of two: the C entry point returns
    cudaErrorInvalidValue, the wrapper raises and counts no launch."""
    p = get_params("nano")
    rng = np.random.default_rng(61)
    n, k1, steps = 12, p.glwe_dimension + 1, 2
    width = 4 * latk.n_groups(p, 1) * n
    acc0 = to_torch_u32(rnd_u32(rng, (1, k1, n)), cuda_device)
    bk_lat = torch.zeros((steps, k1 * 4, width), dtype=torch.int8, device=cuda_device)
    a_vhat = torch.zeros((steps, 1, 1), dtype=torch.int32, device=cuda_device)
    before = latk.KERNEL.launches
    with pytest.raises(RuntimeError, match="invalid argument"):
        latk.blind_rotate_latency(p, acc0, bk_lat, a_vhat)
    assert latk.KERNEL.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("name,variants,batch,steps,kind", [
    # the main path's shapes (random keys, a few steps)
    ("default_128", 1, 1, 3, "random"), ("default_128", 1, 8, 3, "random"),
    ("default_128", 3, 4, 3, "random"),
    # the largest products and digits: the s32 sums at their bound
    ("nano", 1, 3, None, "worst"), ("test_insecure", 1, 8, None, "worst"),
    ("test_insecure", 3, 4, None, "worst"), ("default_128", 1, 1, 2, "worst"),
    # the large degrees: key stages of part of a digit group
    ("large_2048", 1, 2, 2, "random"), ("large_2048", 3, 2, 2, "random"),
    ("large_4096", 1, 1, 2, "random"), ("large_4096", 1, 2, 2, "worst"),
    ("large_4096", 3, 1, 2, "random"),
    # N=16: the warps split the k-chunks
    ("nano_n16", 1, 3, None, "random"), ("nano_n16", 3, 2, None, "worst"),
    # an odd number of levels: the digit phase stores row by row
    ("test_insecure_l5", 1, 2, None, "random"), ("test_insecure_l5", 3, 2, None, "random")])
def test_latency_kernel_matches_twin_at_every_shape_on_card(cuda_device, name, variants, batch,
                                                            steps, kind):
    """Kernel C against its twin, one launch each, under the plan it picks."""
    p = latency_params(name)
    acc0, bk_lat, a_vhat = latency_inputs(p, variants, batch, 180 + batch, steps, kind)
    before = latk.KERNEL.launches
    got = latk.blind_rotate_latency(p, acc0, bk_lat, a_vhat)
    torch.cuda.synchronize()
    assert latk.KERNEL.launches == before + 1
    assert latk.last_plan["ctas"] == batch * latk.last_plan["cluster"]
    assert latk.last_plan["exchanges"] <= 2
    assert torch.equal(got, latk.blind_rotate_latency_ref(p, acc0, bk_lat, a_vhat))


@pytest.mark.cuda
@pytest.mark.parametrize("name,variants,batch,cluster,steps,stages", [
    # the plans with a 1-stage key ring: the picked one at large_4096 V=3,
    # and clusters of 4 at the large degrees and of 2 at N=512 with V=3
    ("large_4096", 3, 1, 0, 9, 1), ("large_4096", 1, 1, 4, 8, 1),
    ("large_2048", 3, 2, 4, 8, 1), ("test_insecure", 3, 2, 2, 10, 1),
    # a ring of 2 stages, and the 8-bit add's B=8 launch
    ("large_2048", 3, 1, 8, 9, 2), ("default_128", 1, 8, 0, 10, 8)])
def test_latency_kernel_matches_twin_over_long_scans_on_card(cuda_device, name, variants, batch,
                                                             cluster, steps, stages):
    """Kernel C against its twin over scans of 8 to 10 steps, which reuse
    each of its three sums buffers at least twice and end in each of them,
    on a random key and on the worst case (every key byte -128, digits -8
    and +16); ``cluster`` 0 lets the entry point pick."""
    p = latency_params(name)
    for kind in ("random", "worst"):
        acc0, bk_lat, a_vhat = latency_inputs(p, variants, batch, 200 + steps, steps, kind)
        before = latk.KERNEL.launches
        got = latk.blind_rotate_latency(p, acc0, bk_lat, a_vhat, cluster)
        torch.cuda.synchronize()
        assert latk.KERNEL.launches == before + 1
        assert cluster in (0, latk.last_plan["cluster"])
        assert latk.last_plan["stages"] == stages
        assert torch.equal(got, latk.blind_rotate_latency_ref(p, acc0, bk_lat, a_vhat))


#: Kernel C's cluster sizes at N=512 that fit the H100's shared memory, by
#: variants
LATENCY_CLUSTERS = {1: [16, 8, 4, 2, 1], 3: [16, 8, 4, 2]}


def latency_params(name):
    """A parameter set by name; ``nano_n16`` is nano at N=16, where a CTA's
    n-tiles fill fewer blocks than there are warps and the warps split the
    k-chunks; ``test_insecure_l5`` is test_insecure with 5 levels of 4 bits."""
    if name == "nano_n16":
        return dataclasses.replace(get_params("nano"), log_degree=4, name=name)
    if name == "test_insecure_l5":
        return dataclasses.replace(get_params("test_insecure"), name=name,
                                   pbs_decomposer=DecomposerParams(log_base=4, levels=5, log_q=32))
    return get_params(name)


@pytest.mark.cuda
@pytest.mark.parametrize("name,variants,cluster", [
    *[("test_insecure", v, cs) for v, sizes in LATENCY_CLUSTERS.items() for cs in sizes],
    # a cluster of one CTA at N=64, the k-split warps at N=16
    ("nano", 1, 1), ("nano", 3, 1), ("nano_n16", 1, 2), ("nano_n16", 3, 1)])
def test_latency_kernel_matches_twin_under_every_plan_on_card(cuda_device, name, variants,
                                                              cluster):
    """Kernel C under each cluster size forced, on a random key for 2 steps
    and on the worst case (every key byte -128, digits -8 and +16)."""
    p = latency_params(name)
    for kind in ("random", "worst"):
        acc0, bk_lat, a_vhat = latency_inputs(p, variants, 2, 190 + cluster, 2, kind)
        before = latk.KERNEL.launches
        got = latk.blind_rotate_latency(p, acc0, bk_lat, a_vhat, cluster)
        torch.cuda.synchronize()
        assert latk.KERNEL.launches == before + 1
        assert latk.last_plan["cluster"] == cluster
        assert torch.equal(got, latk.blind_rotate_latency_ref(p, acc0, bk_lat, a_vhat))


@pytest.mark.cuda
@pytest.mark.parametrize("name,variants,cluster", [
    ("test_insecure", 3, 1),   # the digit words and one key stage pass the shared memory
    ("test_insecure", 1, 3)])  # not a cluster size
def test_latency_kernel_refuses_plans_that_do_not_fit_on_card(cuda_device, name, variants,
                                                              cluster):
    """The C entry point returns cudaErrorInvalidValue for a cluster size
    it cannot run; the wrapper raises and counts no launch."""
    p = get_params(name)
    acc0, bk_lat, a_vhat = latency_inputs(p, variants, 1, 63, 2)
    before = latk.KERNEL.launches
    with pytest.raises(RuntimeError, match="invalid argument"):
        latk.blind_rotate_latency(p, acc0, bk_lat, a_vhat, cluster)
    assert latk.KERNEL.launches == before


@pytest.mark.cuda
def test_latency_kernel_sums_on_tensor_cores_on_card(cuda_device):
    """Kernel C's products are all int8 mma.sync: its library holds IMMA
    instructions and no IDP4A (dp4a) one (cuobjdump -sass)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    from sass_compare import sass_lines

    latk.KERNEL.load()
    sass = sass_lines(latk.KERNEL.path)
    assert sum("IMMA" in ln for ln in sass) > 0
    assert not any("IDP4A" in ln for ln in sass)


def nttf_inputs(p, batch, seed, device, steps=None, kind="random"):
    """acc0, the lhs form of a random canonical key, and exponents for
    Kernel D.  kind='worst': every key byte 0x80 (-128, the largest int8
    products) and an accumulator that step 0 rotates by N (rot - acc =
    -2*acc = 0xF8F8F800), whose carry-chain digits are -8 and the +B
    anomaly 16 in turn (the largest digits)."""
    k1, n = p.glwe_dimension + 1, p.degree
    steps = steps or p.lwe_dimension
    rng = np.random.default_rng(seed)
    bk = to_torch_u32(rnd_u32(rng, (steps, k1 * p.pbs_decomposer.levels, k1, n)), device)
    bk_lhs = ntt.ntt_key_lhs_form(ntt.make_ep_ntt_key(bk, ntt.plan_for_params(p)))
    acc0 = to_torch_u32(rnd_u32(rng, (batch, k1, n)), device)
    a_hat = torch.from_numpy(
        rng.integers(0, 2 * n, size=(steps, batch), dtype=np.int32)).to(device)
    if kind == "worst":
        bk_lhs = torch.full_like(bk_lhs, -128)
        acc0 = to_torch_u32(np.full((batch, k1, n), 0x83838400, np.uint32), device)
        a_hat[0] = n
    return acc0, bk_lhs, a_hat


#: Kernel D's plan instances: (samples per CTA, split)
NTTF_PLANS = [(1, 1), (1, 2), (1, 4), (1, 8), (2, 1), (2, 2), (2, 4), (2, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,batch,steps,plan,kind", [
    # the plans the entry point picks
    ("nano", 3, None, (0, 0), "random"), ("test_insecure", 1, None, (0, 0), "random"),
    ("test_insecure", 7, None, (0, 0), "random"),
    ("test_insecure", 64, None, (0, 0), "random"),
    ("test_insecure", 256, None, (0, 0), "random"),
    ("test_insecure", 1024, 2, (0, 0), "random"),
    # large_2048: 4 key limbs, key stages of chunks of rows, one prime a pass
    ("large_2048", 3, 2, (0, 0), "random"), ("large_2048", 5, 2, (1, 2), "random"),
    # every samples-per-CTA value with every split, each at a batch whose
    # last cluster is partly empty (2 samples per CTA at N=512 take their
    # key slices in chunks of m-tiles; 4 samples per CTA fit only nano's
    # shared memory)
    *[("test_insecure", spc * split + 1, 2, (spc, split), "random")
      for spc, split in NTTF_PLANS],
    *[("nano", 4 * split + 1, None, (4, split), "random") for split in (1, 2, 4)],
    # the largest digits and key bytes: the s32 sums and reductions at their bounds
    ("test_insecure", 9, 2, (2, 4), "worst"), ("large_2048", 2, 2, (1, 1), "worst"),
    # default_128's B=64 plan over 16 steps: every exchange block and key
    # stage reused many times over
    ("test_insecure", 64, 16, (1, 8), "random"), ("test_insecure", 64, 16, (1, 8), "worst")])
def test_nttf_kernel_matches_twin_on_card(cuda_device, name, batch, steps, plan, kind):
    """Kernel D against its twin, one launch each, under the plans it picks
    and every plan instance forced.  A step makes one Dh and one Ch exchange
    of both primes, and at large_2048, whose blocks of both primes do not
    fit the shared memory, two of each, one prime a pass."""
    p = get_params(name)
    acc0, bk_lhs, a_hat = nttf_inputs(p, batch, 80 + batch, cuda_device, steps, kind)
    before = nttk.KERNEL.launches
    got = nttk.blind_rotate_nttf(p, acc0, bk_lhs, a_hat, plan)
    torch.cuda.synchronize()
    assert nttk.KERNEL.launches == before + 1
    got_plan = tuple(nttk.last_plan[k] for k in ("samples_per_cta", "split"))
    assert plan == (0, 0) or got_plan == plan
    assert nttk.last_plan["ctas"] % nttk.last_plan["split"] == 0
    assert nttk.last_plan["exchanges_per_step"] == (4 if name == "large_2048" else 2)
    assert torch.equal(got, nttk.blind_rotate_nttf_ref(p, acc0, bk_lhs, a_hat))


@pytest.mark.cuda
def test_nttf_kernel_refuses_unsupported_shapes_on_card(cuda_device):
    """N1 = 256: the C entry point takes N1 = 64 only (every parameter
    set's); it returns cudaErrorInvalidValue, the wrapper raises and counts
    no launch."""
    p = get_params("test_insecure")
    try:
        ntt.set_plan_n1(256)
        acc0, bk_lhs, a_hat = nttf_inputs(p, 2, 62, cuda_device)
        before = nttk.KERNEL.launches
        with pytest.raises(RuntimeError, match="invalid argument"):
            nttk.blind_rotate_nttf(p, acc0, bk_lhs, a_hat)
        assert nttk.KERNEL.launches == before
    finally:
        ntt.set_plan_n1(None)


#: the whole-scan variants: impl -> (wrapper, twin, options, kernel)
WHOLE_SCAN = {
    "fused3": (brk.blind_rotate_fused, brk.blind_rotate_fused_ref, {"key_limbs": 3},
               brk.KERNEL),
    "fusedb3": (brk.blind_rotate_fused, brk.blind_rotate_fused_ref,
                {"key_limbs": 3, "balanced": True}, brk.KERNEL),
    "fusedp": (brk.blind_rotate_fused_pipe, brk.blind_rotate_fused_pipe_ref, {},
               brk.PIPE_KERNEL),
    "fusedp3": (brk.blind_rotate_fused_pipe, brk.blind_rotate_fused_pipe_ref, {"key_limbs": 3},
                brk.PIPE_KERNEL),
    "fusedw": (brk.blind_rotate_fused_wide_pipe, brk.blind_rotate_fused_wide_pipe_ref, {},
               brk.WIDE_PIPE_KERNEL),
    "fusedwb": (brk.blind_rotate_fused_wide_pipe, brk.blind_rotate_fused_wide_pipe_ref,
                {"balanced": True}, brk.WIDE_PIPE_KERNEL),
    "fusedc": (brk.blind_rotate_fused_cols, brk.blind_rotate_fused_cols_ref, {},
               brk.COLS_KERNEL),
    "fusedc3": (brk.blind_rotate_fused_cols, brk.blind_rotate_fused_cols_ref, {"key_limbs": 3},
                brk.COLS_KERNEL),
}


def kind_of(kernel):
    """The ``smem_bytes`` kind of a whole-scan kernel: its symbol's suffix."""
    return kernel.symbol.removeprefix("blind_rotate_fused").lstrip("_") or "fused"


def whole_scan_inputs(p, batch, seed, device, steps=None):
    """Random acc0 and exponents, and a key with a quarter of its words given
    the low byte 0x80 (where the truncated key is easiest to get wrong)."""
    k1, n = p.glwe_dimension + 1, p.degree
    steps = steps or p.lwe_dimension
    rng = np.random.default_rng(seed)
    bk = rnd_u32(rng, (steps, k1 * p.pbs_decomposer.levels, k1, n))
    flat = bk.reshape(-1)
    idx = rng.choice(flat.size, size=flat.size // 4, replace=False)
    flat[idx] = (flat[idx] & np.uint32(0xFFFFFF00)) | np.uint32(0x80)
    acc0 = to_torch_u32(rnd_u32(rng, (batch, k1, n)), device)
    a_hat = torch.from_numpy(
        rng.integers(0, 2 * n, size=(steps, batch), dtype=np.int32)).to(device)
    return acc0, to_torch_u32(bk, device), a_hat


@pytest.mark.cuda
@pytest.mark.parametrize("impl", list(WHOLE_SCAN))
@pytest.mark.parametrize("name,batch", [("nano", 3), ("test_insecure", 7)])
def test_whole_scan_kernels_match_twins_on_card(cuda_device, impl, name, batch):
    """Kernel B at key_limbs=3 and Kernels E, F and G, each launched once."""
    fn, twin, options, kernel = WHOLE_SCAN[impl]
    p = get_params(name)
    acc0, bk, a_hat = whole_scan_inputs(p, batch, 90 + batch, cuda_device)
    before = kernel.launches
    got = fn(p, acc0, bk, a_hat, **options)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    spc = _build.pick_samples_per_cta(lambda s: brk.smem_bytes(kind_of(kernel), p, s),
                                      _build.smem_budget(cuda_device))
    assert brk.last_plan[kernel.symbol]["samples_per_cta"] == spc
    # the wrapper sizes the shared memory as the C entry point does
    assert brk.last_plan[kernel.symbol]["smem_bytes"] == brk.smem_bytes(kind_of(kernel), p, spc)
    assert torch.equal(got, twin(p, acc0, bk, a_hat, **options))


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["fused3", "fusedp", "fusedw", "fusedc"])
def test_whole_scan_kernels_refuse_shapes_over_the_budget_on_card(cuda_device, monkeypatch,
                                                                  impl):
    """A shape whose one sample passes the card's shared-memory budget raises
    ValueError before any launch, and the twin does not stand in: at
    test_insecure and at large_2048 (the blocked tiling) against a budget
    one byte short of one sample.  Under the card's own budget large_2048
    then runs, one launch, and equals the twin."""
    fn, _, options, kernel = WHOLE_SCAN[impl]
    for name in ("blind_rotate_fused_ref", "blind_rotate_fused_pipe_ref",
                 "blind_rotate_fused_wide_pipe_ref", "blind_rotate_fused_cols_ref"):
        monkeypatch.setattr(brk, name, lambda *a, **k: pytest.fail("the twin ran"))
    kind = kind_of(kernel)
    before = kernel.launches
    for name in ("test_insecure", "large_2048"):
        p = get_params(name)
        acc0, bk, a_hat = whole_scan_inputs(p, 2, 63, cuda_device, steps=1)
        with monkeypatch.context() as m:
            m.setattr(brk, "smem_budget", lambda device: brk.smem_bytes(kind, p, 1) - 1)
            with pytest.raises(ValueError, match="shared memory"):
                fn(p, acc0, bk, a_hat, **options)
    assert kernel.launches == before
    monkeypatch.undo()
    got = fn(p, acc0, bk, a_hat, **options)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(got, WHOLE_SCAN[impl][1](p, acc0, bk, a_hat, **options))


@pytest.mark.cuda
@pytest.mark.parametrize("spc", [1, 2, 4])
@pytest.mark.parametrize("impl", ["fused3", "fusedp", "fusedwb", "fusedc"])
def test_whole_scan_kernels_match_twins_at_fewer_samples_per_cta_on_card(
        cuda_device, monkeypatch, impl, spc):
    """The samples-per-CTA instances the H100's budget does not pick at these
    widths: a budget of exactly S samples' shared memory makes the wrapper
    pick S (B=5 leaves the last CTA part-filled)."""
    fn, twin, options, kernel = WHOLE_SCAN[impl]
    p = get_params("test_insecure")
    kind = kind_of(kernel)
    monkeypatch.setattr(brk, "smem_budget", lambda device: brk.smem_bytes(kind, p, spc))
    acc0, bk, a_hat = whole_scan_inputs(p, 5, 110 + spc, cuda_device)
    got = fn(p, acc0, bk, a_hat, **options)
    torch.cuda.synchronize()
    assert brk.last_plan[kernel.symbol]["samples_per_cta"] == spc
    assert torch.equal(got, twin(p, acc0, bk, a_hat, **options))


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["fusedp", "fusedp3", "fusedw", "fusedwb", "fusedc", "fusedc3"])
@pytest.mark.parametrize("name,batch", [("nano", 9), ("test_insecure", 9)])
def test_mma_whole_scan_kernels_match_twins_on_all_0x80_key_on_card(cuda_device, impl, name,
                                                                    batch):
    """Kernels E, F and G on a key whose every byte is 0x80: every limb of the
    sign-twisted words is -128 or its neighbour, where negating a limb
    instead of the word would be wrong."""
    fn, twin, options, kernel = WHOLE_SCAN[impl]
    p = get_params(name)
    acc0, _, a_hat = whole_scan_inputs(p, batch, 120 + batch, cuda_device)
    k1, n = p.glwe_dimension + 1, p.degree
    bk = to_torch_u32(np.full((p.lwe_dimension, k1 * p.pbs_decomposer.levels, k1, n),
                              0x80808080, np.uint32), cuda_device)
    before = kernel.launches
    got = fn(p, acc0, bk, a_hat, **options)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(got, twin(p, acc0, bk, a_hat, **options))


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["fusedp", "fusedw", "fusedc"])
def test_mma_whole_scan_kernels_refuse_other_degrees_on_card(cuda_device, monkeypatch, impl):
    """Kernels E, F and G take Kernel B's degrees, N a power of two from 64 to
    4096: N=32 raises ValueError before any launch, and the twin does not
    stand in; N=2048 (large_2048), in blocks of 512, runs once and equals
    the twin."""
    fn, twin, options, kernel = WHOLE_SCAN[impl]
    before = kernel.launches
    cases = {}
    for name, n in (("nano", 32), ("large_2048", 2048)):
        p = get_params(name)
        k1 = p.glwe_dimension + 1
        rng = np.random.default_rng(n)
        cases[n] = (p, to_torch_u32(rnd_u32(rng, (1, k1, n)), cuda_device),
                    to_torch_u32(rnd_u32(rng, (1, k1 * p.pbs_decomposer.levels, k1, n)),
                                 cuda_device),
                    torch.from_numpy(rng.integers(0, 2 * n, (1, 1), dtype=np.int32))
                    .to(cuda_device))
    with monkeypatch.context() as m:
        m.setattr(brk, twin.__name__, lambda *a, **k: pytest.fail("the twin ran"))
        with pytest.raises(ValueError, match="from 64 to 4096"):
            fn(*cases[32], **options)
    assert kernel.launches == before
    got = fn(*cases[2048], **options)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(got, twin(*cases[2048], **options))


#: every mode of Kernels B, E, F and G: impl -> (wrapper, twin, options, kernel)
ALL_WHOLE_SCAN = {
    "fused": (brk.blind_rotate_fused, brk.blind_rotate_fused_ref, {}, brk.KERNEL),
    "fusedb": (brk.blind_rotate_fused, brk.blind_rotate_fused_ref, {"balanced": True},
               brk.KERNEL),
    **WHOLE_SCAN,
}


@pytest.mark.cuda
@pytest.mark.parametrize("impl", list(ALL_WHOLE_SCAN))
@pytest.mark.parametrize("name,batch,key", [
    ("large_2048", 8, "random"), ("large_2048", 5, "0x80"), ("large_4096", 3, "random"),
    ("large_4096", 2, "0x80")])
def test_whole_scan_kernels_match_twins_at_large_degrees_on_card(cuda_device, impl, name,
                                                                 batch, key):
    """Every mode of Kernels B, E, F and G at large_2048 and large_4096,
    where they run the circulant in 512 x 512 blocks: 3 steps, one launch,
    equal to the twin, on a random key with low-byte-0x80 words and on a key
    whose every byte is 0x80; B=5 leaves the last CTA part-filled (4 or 2
    samples per CTA), and so do B=3 and B=2 at large_4096 for Kernel B (2
    per CTA)."""
    fn, twin, options, kernel = ALL_WHOLE_SCAN[impl]
    p = get_params(name)
    acc0, bk, a_hat = whole_scan_inputs(p, batch, 130 + batch, cuda_device, steps=3)
    if key == "0x80":
        bk = torch.full_like(bk, 0x80808080 - (1 << 32))
    before = kernel.launches
    got = fn(p, acc0, bk, a_hat, **options)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    spc = _build.pick_samples_per_cta(lambda s: brk.smem_bytes(kind_of(kernel), p, s),
                                      _build.smem_budget(cuda_device))
    assert brk.last_plan[kernel.symbol]["samples_per_cta"] == spc
    assert brk.last_plan[kernel.symbol]["threads"] == (384 if impl.startswith("fusedp") else 256)
    assert torch.equal(got, twin(p, acc0, bk, a_hat, **options))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [brk.KERNEL, brk.PIPE_KERNEL, brk.WIDE_PIPE_KERNEL,
                                    brk.COLS_KERNEL], ids=["B", "E", "F", "G"])
def test_mma_whole_scan_kernels_hold_imma_on_card(cuda_device, kernel):
    """Kernels B, E, F and G compute their sums on the int8 tensor cores:
    their libraries hold IMMA instructions (cuobjdump -sass)."""
    kernel.load()
    assert _build.imma_count(kernel.path) > 0
