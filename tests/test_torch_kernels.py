"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each kernel wrapper runs its plain twin; the twins are held
bit-exactly against the Pallas kernels in interpret mode at ``nano`` shapes
(as tests/test_models.py runs them) and against the JAX scan backends at
``test_insecure``.  tests/test_torch_cuda.py holds each CUDA kernel against
its twin on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu.models import bootstrap as jboot
from tfhe_tpu.models import glwe as jglwe
from tfhe_tpu.models.keys import make_server_key as j_make_server_key
from tfhe_tpu.ops.decomposer import decompose_balanced_planes as j_balanced_planes
from tfhe_tpu.ops.pallas.blind_rotate_kernel import blind_rotate_fused as j_fused
from tfhe_tpu.ops.pallas.ep_kernel import ep_contract_pallas_rbn
from tfhe_tpu.ops.poly import ep_combine as j_ep_combine
from tfhe_tpu.ops.poly import ep_contract_matmul as j_ep_contract_matmul
from tfhe_tpu.params import get_params
from tfhe_tpu_torch.ops.cuda import blind_rotate_kernel as brk
from tfhe_tpu_torch.ops.cuda import ep_kernel as epk
from tfhe_tpu_torch.ops.torus import to_numpy_u32, to_torch_u32
from tfhe_tpu_torch.params import get_params as t_get_params


def rnd_u32(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


def same(torch_u32, jax_u32) -> bool:
    return np.array_equal(to_numpy_u32(torch_u32), np.asarray(jax_u32, np.uint32))


def ep_inputs(name, batch, seed, row_mult=1, digits="chain"):
    """Digits int8[R', B, N] and rows u32[R', C, N], R' = row_mult * R (3 for
    the bmmp scan's rows); digits in the carry chain's range or the full
    int8 range ('full')."""
    p = t_get_params(name)
    k1, n = p.glwe_dimension + 1, p.degree
    r = k1 * p.pbs_decomposer.levels * row_mult
    rng = np.random.default_rng(seed)
    lo, hi = (-8, 17) if digits == "chain" else (-128, 128)
    digits = rng.integers(lo, hi, size=(r, batch, n), dtype=np.int8)
    rows = rnd_u32(rng, (r, k1, n))
    rows[0, 0, :4] = [0, 2**31, 2**32 - 1, 0x80808080]
    return digits, rows


def rotate_inputs(name, batch, seed, steps=None):
    p = t_get_params(name)
    k1, n = p.glwe_dimension + 1, p.degree
    steps = steps or p.lwe_dimension
    rng = np.random.default_rng(seed)
    acc0 = rnd_u32(rng, (batch, k1, n))
    bk = rnd_u32(rng, (steps, k1 * p.pbs_decomposer.levels, k1, n))
    a_hat = rng.integers(0, 2 * n, size=(steps, batch), dtype=np.int32)
    return p, acc0, bk, a_hat


# ---------------------------------------------------------------------------
# Kernel A: ep_contract_rbn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch,row_mult,digit_range", [
    pytest.param(1, 1, "chain", id="1"), pytest.param(8, 1, "chain", id="8"),
    pytest.param(5, 1, "full", id="full-R"), pytest.param(5, 3, "full", id="full-3R")])
def test_ep_contract_rbn_matches_pallas_interpret(batch, row_mult, digit_range):
    """The twin against the Pallas kernel in interpret mode, also on
    full-range int8 digits at R rows and at the bmmp scan's 3R rows."""
    digits, rows = ep_inputs("nano", batch, seed=batch, row_mult=row_mult, digits=digit_range)
    want = np.asarray(ep_contract_pallas_rbn(jnp.asarray(digits), jnp.asarray(rows),
                                             interpret=True))
    ref = epk.ep_contract_rbn_ref(torch.from_numpy(digits), to_torch_u32(rows))
    assert np.array_equal(ref.numpy(), want)
    # on CPU tensors the wrapper is the plain twin
    got = epk.ep_contract_rbn(torch.from_numpy(digits), to_torch_u32(rows))
    assert torch.equal(got, ref)


# ---------------------------------------------------------------------------
# Kernel B: blind_rotate_fused
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("balanced", [False, True], ids=["fused", "fusedb"])
def test_blind_rotate_fused_matches_pallas_interpret(balanced):
    p, acc0, bk, a_hat = rotate_inputs("nano", 8, seed=21)
    want = j_fused(get_params("nano"), jnp.asarray(acc0), jnp.asarray(bk),
                   jnp.asarray(a_hat), interpret=True, balanced=balanced)
    args = (p, to_torch_u32(acc0), to_torch_u32(bk), torch.from_numpy(a_hat))
    ref = brk.blind_rotate_fused_ref(*args, balanced=balanced)
    assert same(ref, want)
    assert torch.equal(brk.blind_rotate_fused(*args, balanced=balanced), ref)


@pytest.fixture(scope="module")
def insecure_key():
    """A test_insecure server key from random injected key material (the
    rotation's exactness does not depend on the key being well formed)."""
    p = get_params("test_insecure")
    rng = np.random.default_rng(33)
    k, n_deg, n = p.glwe_dimension, p.degree, p.lwe_dimension
    rows = (k + 1) * p.pbs_decomposer.levels
    kn = k * n_deg
    jsk = j_make_server_key(
        p, rng.integers(0, 2, size=n, dtype=np.uint32),
        rng.integers(0, 2, size=(k, n_deg), dtype=np.uint32),
        rnd_u32(rng, (n, rows, k, n_deg)), rnd_u32(rng, (n, rows, n_deg)),
        rnd_u32(rng, (kn * p.ks_decomposer.levels, n)),
        rnd_u32(rng, (kn * p.ks_decomposer.levels,)))
    approx = rng.integers(0, 2 * n_deg, size=(3, n + 1), dtype=np.uint32)
    tv = rnd_u32(rng, (n_deg,))
    return p, jsk, jnp.asarray(approx), jnp.asarray(tv)


def test_blind_rotate_fused_ref_matches_conv_scan(insecure_key):
    p, jsk, approx, tv = insecure_key
    want = jboot.blind_rotate(p, approx, jsk, tv, impl="conv")
    acc0, a_hat = jboot._init_acc(p, approx, tv)
    got = brk.blind_rotate_fused_ref(
        t_get_params("test_insecure"), to_torch_u32(np.asarray(acc0)),
        to_torch_u32(np.asarray(jsk.bk_u32)), torch.from_numpy(np.array(a_hat)))
    assert same(got, want)


def test_blind_rotate_fused_ref_balanced_matches_xla_scan(insecure_key):
    """The balanced digits against the XLA balanced scan of
    tests/test_models.py (closed-form decomposition, matmul contraction)."""
    p, jsk, approx, tv = insecure_key
    k1, levels = p.glwe_dimension + 1, p.pbs_decomposer.levels
    acc0, a_hat = jboot._init_acc(p, approx, tv)
    acc = acc0
    for i in range(p.lwe_dimension):
        rot = jglwe.mul_monomial(acc, a_hat[i])
        digs = jnp.moveaxis(j_balanced_planes(rot - acc, p.pbs_decomposer), 0, -2)
        digs = digs.reshape(digs.shape[0], k1 * levels, p.degree)
        acc = acc + j_ep_combine(j_ep_contract_matmul(digs, jsk.bk_u32[i]), k1)
    got = brk.blind_rotate_fused_ref(
        t_get_params("test_insecure"), to_torch_u32(np.asarray(acc0)),
        to_torch_u32(np.asarray(jsk.bk_u32)), torch.from_numpy(np.array(a_hat)),
        balanced=True)
    assert same(got, acc)


# ---------------------------------------------------------------------------
# wrappers: CPU tensors take the twin, CUDA tensors the kernel, others raise
# ---------------------------------------------------------------------------


def test_wrappers_refuse_other_devices():
    digits, rows = ep_inputs("nano", 2, seed=5)
    with pytest.raises(ValueError):
        epk.ep_contract_rbn(torch.from_numpy(digits).to("meta"), to_torch_u32(rows).to("meta"))
    p, acc0, bk, a_hat = rotate_inputs("nano", 2, seed=6)
    with pytest.raises(ValueError):
        brk.blind_rotate_fused(p, to_torch_u32(acc0).to("meta"), to_torch_u32(bk).to("meta"),
                               torch.from_numpy(a_hat).to("meta"))
    assert epk.KERNEL.launches == 0 and brk.KERNEL.launches == 0
