"""The port's ops layer (tfhe_tpu_torch.ops, params, test vectors) against the
JAX package: the same numpy inputs through both, bit-exact (tolerance 0: all
arithmetic is integer)."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu import params as jparams
from tfhe_tpu.models import test_vector as jtv
from tfhe_tpu.ops import decomposer as jdec
from tfhe_tpu.ops import poly as jpoly
from tfhe_tpu.ops import torus as jtorus
from tfhe_tpu_torch import params as tparams
from tfhe_tpu_torch.models import test_vector as ttv
from tfhe_tpu_torch.ops import decomposer as tdec
from tfhe_tpu_torch.ops import poly as tpoly
from tfhe_tpu_torch.ops import torus as ttorus
from tfhe_tpu_torch.ops.torus import to_numpy_u32, to_torch_u32

EDGE = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1, 0x80808080, 0x7F7F7F7F,
                 0xFFFFFF80, 0x00000080, 0x7FFFFFFF], dtype=np.uint32)


def u32_values(seed, n=4096):
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGE, rng.integers(0, 1 << 32, size=n, dtype=np.uint32)])


def same(torch_u32, jax_u32) -> bool:
    return np.array_equal(to_numpy_u32(torch_u32), np.asarray(jax_u32, np.uint32))


def same_int(torch_t, jax_t) -> bool:
    return np.array_equal(torch_t.numpy(), np.asarray(jax_t))


# ---------------------------------------------------------------------------
# params and test vectors
# ---------------------------------------------------------------------------


def test_registry_matches_jax():
    assert tparams.PARAMS.keys() == jparams.PARAMS.keys()
    for name, p in jparams.PARAMS.items():
        assert dataclasses.asdict(tparams.get_params(name)) == dataclasses.asdict(p)


def test_validate_rejects_like_jax():
    bad = dict(log_q=31)
    for mod in (jparams, tparams):
        with pytest.raises(ValueError):
            mod.get_params("nano").replace(**bad)


@pytest.mark.parametrize("name", ["nano", "test_insecure", "nano_3in", "default_128"])
def test_test_vectors_match(name):
    tp, jp = tparams.get_params(name), jparams.get_params(name)
    for gate in jtv.GATE_FNS:
        assert np.array_equal(ttv.gate_test_vector(tp, gate), jtv.gate_test_vector(jp, gate))
    assert np.array_equal(ttv.identity_test_vector(tp), jtv.identity_test_vector(jp))
    lut = tuple(range(1 << jp.log_p))[::-1]
    assert np.array_equal(ttv.lut_test_vector(tp, lut), jtv.lut_test_vector(jp, lut))
    if jp.log_p >= 3:
        for gate in jtv.GATE3_FNS:
            assert np.array_equal(ttv.gate3_test_vector(tp, gate),
                                  jtv.gate3_test_vector(jp, gate))


# ---------------------------------------------------------------------------
# torus
# ---------------------------------------------------------------------------


def test_u32_carrier_roundtrip_and_logical_shift():
    v = u32_values(1)
    t = to_torch_u32(v)
    assert t.dtype == torch.int32
    assert np.array_equal(to_numpy_u32(t), v)
    for s in (0, 1, 4, 8, 24, 31):
        assert np.array_equal(to_numpy_u32(ttorus.shr(t, s)), v >> np.uint32(s)), s
    assert ttorus.i32(0xFFFFFFFF) == -1 and ttorus.i32(2**31) == -(2**31)


def test_torus_functions_match():
    v = u32_values(2)
    t = to_torch_u32(v)
    for log_p, pad in ((2, 1), (3, 1), (1, 0)):
        assert same(ttorus.encode(t & 7, 32, log_p, pad), jtorus.encode(v & 7, 32, log_p, pad))
        assert same(ttorus.decode(t, 32, log_p, pad), jtorus.decode(v, 32, log_p, pad))
    for log_to in (7, 10, 11, 13):
        assert same(ttorus.switch_modulus(t, 32, log_to), jtorus.switch_modulus(v, 32, log_to))
    limbs = ttorus.to_signed_limbs(t)
    assert same_int(limbs, jtorus.to_signed_limbs(v))
    accs = np.random.default_rng(3).integers(-(2**31), 2**31, size=(257, 4), dtype=np.int32)
    assert same(ttorus.combine_limb_accs(torch.from_numpy(accs)),
                jtorus.combine_limb_accs(jnp.asarray(accs)))
    assert same(ttorus.combine_limb_accs(limbs.to(torch.int32)), v)


def test_wrapping_matvec_matches():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 1 << 32, size=(5, 64), dtype=np.uint32)
    a[0, :10] = EDGE
    w = rng.integers(-127, 128, size=(64, 7), dtype=np.int8)
    assert same(ttorus.wrapping_matvec_u32_small(to_torch_u32(a), torch.from_numpy(w)),
                jtorus.wrapping_matvec_u32_small(a, w))


# ---------------------------------------------------------------------------
# decomposer
# ---------------------------------------------------------------------------

DECOMPOSERS = [
    jparams.DecomposerParams(log_base=4, levels=6, log_q=32),  # pbs
    jparams.DecomposerParams(log_base=4, levels=5, log_q=32),  # key switch
    jparams.DecomposerParams(log_base=2, levels=7, log_q=32),
    jparams.DecomposerParams(log_base=4, levels=8, log_q=32),  # no ignored bits
]


@pytest.mark.parametrize("jdp", DECOMPOSERS, ids=lambda d: f"b{d.log_base}l{d.levels}")
def test_decomposer_matches(jdp):
    dp = tparams.DecomposerParams(**dataclasses.asdict(jdp))
    v = u32_values(5)
    t = to_torch_u32(v)
    assert same(tdec.round_value(t, dp), jdec.round_value(v, jdp))
    digits = tdec.decompose_u32(t, dp)
    assert same(digits, jdec.decompose_u32(v, jdp))
    assert same_int(tdec.decompose_signed(t, dp), jdec.decompose_signed(v, jdp))
    assert same_int(tdec.digits_to_signed(digits, dp),
                    jdec.digits_to_signed(jdec.decompose_u32(v, jdp), jdp))
    assert same_int(tdec.decompose_signed_planes(t, dp), jdec.decompose_signed_planes(v, jdp))
    assert tdec.balanced_offset(dp) == jdec.balanced_offset(jdp)
    bal = tdec.decompose_balanced_planes(t, dp)
    assert same_int(bal, jdec.decompose_balanced_planes(v, jdp))
    assert same(tdec.recompose(digits, dp), jdec.recompose(jdec.decompose_u32(v, jdp), jdp))
    # both conventions reconstruct the rounded value exactly
    rounded = tdec.round_value(t, dp)
    assert torch.equal(tdec.recompose(digits, dp), rounded)
    assert torch.equal(tdec.recompose(bal.movedim(0, -1).to(torch.int32), dp), rounded)
    half = 1 << (dp.log_base - 1)
    assert int(bal.min()) >= -half and int(bal.max()) < half


# ---------------------------------------------------------------------------
# polynomial ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [64, 512])
def test_monomial_mul_matches(n):
    rng = np.random.default_rng(6)
    poly = rng.integers(0, 1 << 32, size=(3, 2, n), dtype=np.uint32)
    t = to_torch_u32(poly)
    for e in (-3 * n - 5, -n, -1, 0, 3, n - 1, n, n + 1, 2 * n - 1, 2 * n, 5 * n + 7):
        assert same(tpoly.monomial_mul(t, e), jpoly.monomial_mul(poly, e)), e
    per_sample = np.array([[-700], [n + 3], [2 * n + 1]], dtype=np.int32)
    assert same(tpoly.monomial_mul(t, torch.from_numpy(per_sample)),
                jpoly.monomial_mul(poly, per_sample))


def test_toeplitz_and_matvec_match():
    rng = np.random.default_rng(7)
    p = rng.integers(0, 1 << 32, size=(2, 64), dtype=np.uint32)
    p[0, :10] = EDGE
    assert same(tpoly.sign_toeplitz_u32(to_torch_u32(p)), jpoly.sign_toeplitz_u32(p))
    bits = rng.integers(0, 2, size=(2, 64), dtype=np.uint32)
    ts = tpoly.sign_toeplitz_small(torch.from_numpy(bits.astype(np.int8)))
    js = jpoly.sign_toeplitz_small(bits)
    assert same_int(ts, js)
    a = rng.integers(0, 1 << 32, size=(3, 128), dtype=np.uint32)
    assert same(tpoly.negacyclic_matvec_u32_small(to_torch_u32(a), ts.reshape(128, 64)),
                jpoly.negacyclic_matvec_u32_small(a, js.reshape(128, 64)))


@pytest.mark.parametrize("name,batch", [("nano", 5), ("test_insecure", 2)])
def test_ep_contract_matmul_matches(name, batch):
    p = jparams.get_params(name)
    k1, n = p.glwe_dimension + 1, p.degree
    r = k1 * p.pbs_decomposer.levels
    rng = np.random.default_rng(8)
    digits = rng.integers(-8, 17, size=(batch, r, n), dtype=np.int8)
    bk = rng.integers(0, 1 << 32, size=(r, k1, n), dtype=np.uint32)
    bk[0, 0, :10] = EDGE
    bk_t = to_torch_u32(bk)
    assert same_int(tpoly.bk_to_matmul_w(bk_t), jpoly.bk_to_matmul_w(bk))
    raw_t = tpoly.ep_contract_matmul(torch.from_numpy(digits), bk_t)
    raw_j = jpoly.ep_contract_matmul(digits, bk)
    assert same_int(raw_t, raw_j)
    assert same(tpoly.ep_combine(raw_t, k1), jpoly.ep_combine(raw_j, k1))
    planes = raw_t.reshape(batch, k1, 4, n).permute(1, 2, 0, 3)
    assert same(tpoly.ep_combine_planes(planes),
                jpoly.ep_combine_planes(jnp.asarray(planes.numpy())))
    assert np.array_equal(tpoly.level_major_row_perm(k1, p.pbs_decomposer.levels),
                          jpoly.level_major_row_perm(k1, p.pbs_decomposer.levels))


# ---------------------------------------------------------------------------
# import hygiene: the port runs where JAX is not installed
# ---------------------------------------------------------------------------


def test_port_imports_neither_jax_nor_tfhe_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import tfhe_tpu_torch\n"
        "for m in pkgutil.walk_packages(tfhe_tpu_torch.__path__, 'tfhe_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tfhe_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('tfhe_tpu_torch')]))\n"
    )
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 18
