"""The block-NTT tier of the port (``ops/ntt.py``, the NTT key forms,
``impl='ntt'``/``'ntts'``/``'nttf'``) against the JAX package.

Every comparison is bit-exact (tolerance 0, ``np.array_equal``) on the same
numpy inputs.  The JAX side runs its Pallas NTT kernel in interpret mode, as
tests/test_models.py does.  On the CPU the port's Kernel D wrapper runs its
plain twin.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_tpu as jtfhe
from tfhe_tpu.models import bootstrap as jboot
from tfhe_tpu.models import test_vector as jtv
from tfhe_tpu.models.keys import with_ntt_key as j_with_ntt_key
from tfhe_tpu.models.keys import with_ntt_lhs_key as j_with_ntt_lhs_key
from tfhe_tpu.ops import ntt as jntt
from tfhe_tpu.ops.poly import ep_combine as j_ep_combine
from tfhe_tpu.ops.poly import ep_contract_matmul as j_ep_contract_matmul
from tfhe_tpu_torch.models import bootstrap as tboot
from tfhe_tpu_torch.models import keys as tkeys
from tfhe_tpu_torch.ops import ntt as tntt
from tfhe_tpu_torch.ops.cuda import blind_rotate_kernel as brk
from tfhe_tpu_torch.ops.cuda import ntt_kernel as nttk
from tfhe_tpu_torch.ops.torus import to_numpy_u32, to_torch_u32
from tfhe_tpu_torch.params import get_params as t_get_params

PARAM_NAMES = ["nano", "test_insecure", "default_128", "large_2048"]


def rnd_u32(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


def same(torch_u32, jax_u32) -> bool:
    return np.array_equal(to_numpy_u32(torch_u32), np.asarray(jax_u32, np.uint32))


def ep_shape(name):
    p = t_get_params(name)
    k1 = p.glwe_dimension + 1
    return k1 * p.pbs_decomposer.levels, k1, p.degree


def random_key(rng, shape):
    """Random u32 key rows with the words that stress the limb split."""
    bk = rnd_u32(rng, shape)
    bk.reshape(-1)[:6] = [0, 2**31, 2**32 - 1, 2**31 - 1, 0x80808080, 0x7FFFFFFF]
    return bk


# ---------------------------------------------------------------------------
# ops/ntt.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", PARAM_NAMES)
def test_tables_and_plans_match_jax(name):
    jp, tp = jtfhe.get_params(name), t_get_params(name)
    jplan, tplan = jntt.plan_for_params(jp), tntt.plan_for_params(tp)
    assert dataclasses.asdict(jplan) == dataclasses.asdict(tplan)
    assert tplan.n2 == jplan.n2
    for jt, tt in zip(jntt._tables(tplan.n1), tntt._tables(tplan.n1)):
        for k in ("w_fwd", "w_inv", "zhat"):
            assert np.array_equal(jt[k], tt[k]), k
    r, _, n = ep_shape(name)
    for kw in (dict(rows=r), dict(rows=4, max_digit=128), dict(rows=r, n1=16)):
        assert dataclasses.asdict(jntt.make_plan(n, **kw)) == dataclasses.asdict(
            tntt.make_plan(n, **kw)), kw


@pytest.mark.parametrize("name", ["nano", "test_insecure"])
def test_ntt_key_forms_byte_equal_to_jax(name):
    r, c, n = ep_shape(name)
    plan = tntt.plan_for_params(t_get_params(name))
    bk = random_key(np.random.default_rng(100), (2, r, c, n))
    want = np.asarray(jntt.make_ep_ntt_key(bk, jntt.plan_for_params(jtfhe.get_params(name))))
    got = tntt.make_ep_ntt_key(to_torch_u32(bk), plan)
    assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)
    lhs = tntt.ntt_key_lhs_form(got)
    assert np.array_equal(lhs.numpy(), np.asarray(jntt.ntt_key_lhs_form(want)))
    assert tuple(lhs.shape) == nttk.lhs_key_shape(t_get_params(name), plan, 2)
    assert torch.equal(tntt.ntt_key_rhs_form(lhs), got)
    limbs = tntt.key_limbs_i32(to_torch_u32(bk), plan.key_bits, plan.key_limbs)
    assert np.array_equal(limbs.numpy(), np.asarray(
        jntt.key_limbs_i32(bk, plan.key_bits, plan.key_limbs)))


def _ep_cases(name):
    r, c, n = ep_shape(name)
    rng = np.random.default_rng(101)
    yield "random", rng.integers(-8, 17, size=(4, r, n)).astype(np.int8), rnd_u32(rng, (r, c, n))
    if name == "default_128":
        # digits at the +B carry anomaly against an all-ones key: the true
        # convolution reaches its CRT bound R*N*16*2^(kb-1)
        yield ("worst", np.full((1, r, n), 16, np.int8),
               np.full((r, c, n), 0xFFFFFFFF, np.uint32))
        # alternating-sign extremes: the negative bound
        even = np.arange(n) % 2 == 0
        yield ("signed", np.where(even, 16, -8).astype(np.int8) * np.ones((1, r, 1), np.int8),
               np.where(even, 0x80000000, 0x7FFFFFFF).astype(np.uint32)
               * np.ones((r, c, 1), np.uint32))


@pytest.mark.parametrize("name", ["test_insecure", "default_128"])
def test_ep_contract_ntt_matches_jax(name):
    _, c, n = ep_shape(name)
    plan = tntt.plan_for_params(t_get_params(name))
    jplan = jntt.plan_for_params(jtfhe.get_params(name))
    for case, digits, bk in _ep_cases(name):
        want = np.asarray(jntt.ep_contract_ntt(
            jnp.asarray(digits), jntt.make_ep_ntt_key(bk, jplan), jplan, c_dim=c))
        toeplitz = j_ep_combine(j_ep_contract_matmul(jnp.asarray(digits), bk), c)
        assert np.array_equal(want, np.asarray(toeplitz)), case
        got = tntt.ep_contract_ntt(torch.from_numpy(digits),
                                   tntt.make_ep_ntt_key(to_torch_u32(bk), plan), plan, c)
        assert same(got, want), case


@pytest.mark.parametrize("shards", [2, 4])
def test_bin_partials_sum_to_the_contraction(shards):
    """Bin-partial raw INTT limb planes equal the JAX package's, and summed
    over the shards they finish to the single-shot contraction."""
    r, c, n = ep_shape("test_insecure")
    plan = tntt.plan_for_params(t_get_params("test_insecure"))
    jplan = jntt.plan_for_params(jtfhe.get_params("test_insecure"))
    rng = np.random.default_rng(102)
    digits = rng.integers(-8, 17, size=(3, r, n)).astype(np.int8)
    bk = rnd_u32(rng, (r, c, n))
    jkey = jntt.make_ep_ntt_key(bk, jplan)
    key = tntt.make_ep_ntt_key(to_torch_u32(bk), plan)
    want = np.asarray(jntt.ep_contract_ntt(jnp.asarray(digits), jkey, jplan, c_dim=c))
    bl = plan.n1 // shards
    total = 0
    for s in range(shards):
        part = tntt.ep_contract_ntt_partial(torch.from_numpy(digits),
                                            key[:, :, s * bl:(s + 1) * bl], plan, c, s * bl, bl)
        jpart = jntt.ep_contract_ntt_partial(jnp.asarray(digits), jkey[:, :, s * bl:(s + 1) * bl],
                                             jplan, c, s * bl, bl)
        assert np.array_equal(part.numpy(), np.asarray(jpart)), s
        total = total + part
    assert same(tntt.ep_finish_ntt(total, plan, c), want)


@pytest.mark.parametrize("n", [64, 512])
def test_poly_mul_ntt_matches_jax(n):
    rng = np.random.default_rng(103)
    a, b = rnd_u32(rng, (3, n)), rnd_u32(rng, (3, n))
    a[0], b[0] = 0xFFFFFFFF, 0xFFFFFFFF  # every intermediate at its largest
    want = np.asarray(jntt.poly_mul_ntt(a, b))
    assert same(tntt.poly_mul_ntt(to_torch_u32(a), to_torch_u32(b)), want)


# ---------------------------------------------------------------------------
# NTT key forms on a server key, and the guard
# ---------------------------------------------------------------------------


def port_keys(jck, jsk, name):
    return tkeys.keys_from_numpy(t_get_params(name), np.asarray(jck.lwe_sk),
                                 np.asarray(jck.glwe_sk), np.asarray(jsk.bk_u32),
                                 np.asarray(jsk.ksk_u32), device="cpu")


@pytest.fixture(scope="module")
def insecure_keys():
    """A JAX test_insecure key with both NTT forms, carried into the port."""
    p = jtfhe.get_params("test_insecure")
    jck, jsk = jtfhe.keygen(p, jax.random.key(31))
    tck, tsk = port_keys(jck, jsk, "test_insecure")
    return jck, j_with_ntt_lhs_key(j_with_ntt_key(jsk)), tck, tsk


def test_with_ntt_keys_byte_equal_to_jax(insecure_keys):
    _, jsk, _, tsk = insecure_keys
    sk = tkeys.with_ntt_key(tsk)
    assert sk.bk_ntt.dtype == torch.int8
    assert np.array_equal(sk.bk_ntt.numpy(), np.asarray(jsk.bk_ntt))
    both = tkeys.with_ntt_lhs_key(sk)  # a relayout of bk_ntt
    assert both.bk_ntt is sk.bk_ntt
    assert np.array_equal(both.bk_ntt_lhs.numpy(), np.asarray(jsk.bk_ntt_lhs))
    direct = tkeys.with_ntt_lhs_key(tsk, drop_rhs=True)  # from bk_u32, no rhs form
    assert direct.bk_ntt is None and torch.equal(direct.bk_ntt_lhs, both.bk_ntt_lhs)
    assert tkeys.with_ntt_lhs_key(sk, drop_rhs=True).bk_ntt is None
    moved = both.to("cpu")
    assert torch.equal(moved.bk_ntt_lhs, both.bk_ntt_lhs) and torch.equal(moved.bk_ntt, sk.bk_ntt)
    assert tkeys.ntt_form_bytes(t_get_params("test_insecure")) == sk.bk_ntt.numel()


def test_ntt_key_guard_counts_the_peak(insecure_keys, monkeypatch):
    """With a budget that holds one form and a chunk's workspace, a key that
    already holds bk_ntt cannot grow the lhs form, not even with
    drop_rhs=True: both forms are alive while it converts (the JAX package
    counts one there)."""
    _, _, _, tsk = insecure_keys
    form = tkeys.ntt_form_bytes(t_get_params("test_insecure"))
    one = tkeys.ntt_build_peak_bytes(tsk)
    assert one > form
    monkeypatch.setattr(tkeys, "NTT_KEY_BUDGET_BYTES", one)
    sk = tkeys.with_ntt_key(tsk)
    assert tkeys.ntt_build_peak_bytes(sk) == one + form
    assert tkeys.with_ntt_lhs_key(tsk, drop_rhs=True).bk_ntt_lhs is not None
    for drop_rhs in (False, True):
        with pytest.raises(ValueError, match="2 NTT key form"):
            tkeys.with_ntt_lhs_key(sk, drop_rhs=drop_rhs)
    with pytest.raises(ValueError, match="budget"):
        tkeys.with_ntt_key(sk)  # rebuilding next to the old form
    monkeypatch.setattr(tkeys, "NTT_KEY_BUDGET_BYTES", one + form)
    assert tkeys.with_ntt_lhs_key(sk, drop_rhs=True).bk_ntt is None
    monkeypatch.setattr(tkeys, "NTT_KEY_BUDGET_BYTES", one - 1)
    with pytest.raises(ValueError, match="budget"):
        tkeys.with_ntt_key(tsk)  # one form and its chunk's workspace


# ---------------------------------------------------------------------------
# the PBS through ntt, ntts and nttf
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["nano", "test_insecure"])
def test_pbs_ntt_and_ntts_match_jax(name):
    p = jtfhe.get_params(name)
    jck, jsk = jtfhe.keygen(p, jax.random.key(32))
    jsk = j_with_ntt_key(jsk)
    _, tsk = port_keys(jck, jsk, name)
    tsk = tkeys.with_ntt_key(tsk)
    cts = np.asarray(jtfhe.encrypt(jck, np.arange(5, dtype=np.uint32) % 2, key=4))
    tv = jtv.identity_test_vector(p)
    tp = t_get_params(name)
    for impl in ("ntt", "ntts"):
        want = np.asarray(jboot.pbs(p, jnp.asarray(cts), jsk, jnp.asarray(tv), impl=impl))
        got = tboot.pbs(tp, to_torch_u32(cts), tsk, to_torch_u32(tv), impl=impl)
        assert same(got, want), impl


def test_pbs_nttf_matches_jax_interpret(insecure_keys):
    """Kernel D's twin through the whole PBS against the Pallas kernel in
    interpret mode, on the lhs form alone (drop_rhs=True)."""
    jck, jsk, _, tsk = insecure_keys
    p = jtfhe.get_params("test_insecure")
    cts = np.asarray(jtfhe.encrypt(jck, np.array([0, 1], dtype=np.uint32), key=5))
    tv = jtv.identity_test_vector(p)
    want = np.asarray(jboot.pbs(p, jnp.asarray(cts), jsk, jnp.asarray(tv), impl="nttf_interpret"))
    sk = tkeys.with_ntt_lhs_key(tsk, drop_rhs=True)
    got = tboot.pbs(t_get_params("test_insecure"), to_torch_u32(cts), sk, to_torch_u32(tv),
                    impl="nttf")
    assert same(got, want)
    assert nttk.KERNEL.launches == 0  # CPU tensors run the twin


def test_nttf_twin_equals_fused_twin():
    """The block-NTT twin and Kernel B's twin (reference digits) give the same
    bits on random accumulators, keys and exponents."""
    p = t_get_params("test_insecure")
    k1, n = p.glwe_dimension + 1, p.degree
    rng = np.random.default_rng(104)
    bk = to_torch_u32(random_key(rng, (p.lwe_dimension, k1 * p.pbs_decomposer.levels, k1, n)))
    acc0 = to_torch_u32(rnd_u32(rng, (3, k1, n)))
    a_hat = torch.from_numpy(rng.integers(0, 2 * n, size=(p.lwe_dimension, 3), dtype=np.int32))
    lhs = tntt.ntt_key_lhs_form(tntt.make_ep_ntt_key(bk, tntt.plan_for_params(p)))
    assert torch.equal(nttk.blind_rotate_nttf(p, acc0, lhs, a_hat),
                       brk.blind_rotate_fused_ref(p, acc0, bk, a_hat))


def test_kernel_tables_hold_the_transforms():
    """Kernel D's transform operands are the m16n8k32 A fragments of w_fwd^T
    and w_inv^T (PTX ISA, s8 A layout: lane 4g+c holds in register 0 row g,
    k = 4c..4c+3, in 1 row g+8, in 2 and 3 the same at k+16), rows 0-7 of a
    tile the hi bytes and rows 8-15 the lo bytes of 8 table rows: every entry
    is held once and hi*256 + lo gives the table back."""
    tabs = nttk.kernel_tables(64, "cpu").to(torch.int64).numpy()
    assert tabs.shape == (2, 2, 8, 32, 2, 4, 4)
    for pi, t in enumerate(tntt._tables(64)):
        for which, mat in enumerate((t["w_fwd"].T, t["w_inv"].T)):
            planes = np.zeros((2, 64, 64), np.int64)
            held = np.zeros((2, 64, 64), np.int64)
            for tile, lane, step, reg, byte in np.ndindex(8, 32, 2, 4, 4):
                mrow = lane // 4 + 8 * (reg % 2)  # the row of the m16 tile
                plane, row = mrow // 8, 8 * tile + mrow % 8
                k = 32 * step + 16 * (reg // 2) + 4 * (lane % 4) + byte
                planes[plane, row, k] = tabs[pi, which, tile, lane, step, reg, byte]
                held[plane, row, k] += 1
            assert (held == 1).all()
            assert np.array_equal(planes[0] * 256 + planes[1], mat)
            assert (planes[1] >= -128).all() and (planes[1] < 128).all()


def test_ntt_impls_refuse_missing_key_forms(insecure_keys):
    _, _, _, tsk = insecure_keys
    p = t_get_params("test_insecure")
    ct = torch.zeros((1, p.lwe_dimension + 1), dtype=torch.int32)
    tv = torch.zeros(p.degree, dtype=torch.int32)
    with pytest.raises(ValueError, match="with_ntt_key"):
        tboot.pbs(p, ct, tsk, tv, impl="ntt")
    with pytest.raises(ValueError, match="with_ntt_lhs_key"):
        tboot.pbs(p, ct, tkeys.with_ntt_key(tsk), tv, impl="nttf")
    lhs_only = tkeys.with_ntt_lhs_key(tsk, drop_rhs=True)
    with pytest.raises(ValueError, match="with_ntt_key"):
        tboot.pbs(p, ct, lhs_only, tv, impl="ntt")
    with pytest.raises(ValueError):  # neither CPU nor CUDA tensors
        nttk.blind_rotate_nttf(p, torch.zeros((1, 3, p.degree), dtype=torch.int32).to("meta"),
                               lhs_only.bk_ntt_lhs.to("meta"),
                               torch.zeros((p.lwe_dimension, 1), dtype=torch.int32).to("meta"))
    assert {"ntt", "ntts", "nttf"} <= set(tboot.VALID_IMPLS)
    assert tboot.resolve_impl("auto", "cpu") == "matmul"
    assert nttk.KERNEL.launches == 0
