"""The port's slice as a whole — programmable bootstrap and gates — against
the JAX package, bit-exact, and gate truth tables through the port alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_tpu as jtfhe
import tfhe_tpu.golden.model as g
import tfhe_tpu_torch as ttfhe
from tfhe_tpu.models import bootstrap as jboot
from tfhe_tpu.models import lwe as jlwe
from tfhe_tpu.models import test_vector as jtv
from tfhe_tpu.models.keys import make_server_key as j_make_server_key
from tfhe_tpu_torch.models import bootstrap as tboot
from tfhe_tpu_torch.models import test_vector as ttv
from tfhe_tpu_torch.models.keys import keys_from_numpy
from tfhe_tpu_torch.ops.torus import to_numpy_u32, to_torch_u32

BITS_A = np.array([0, 0, 1, 1], dtype=np.uint32)
BITS_B = np.array([0, 1, 0, 1], dtype=np.uint32)


def rnd_u32(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


def gaussian_u32(rng, std, shape):
    return g.f64_to_torus(rng.normal(0.0, std, size=shape))


@pytest.fixture(scope="module")
def insecure():
    """test_insecure keys from injected randomness, shared by both packages,
    and four ciphertexts of the messages 0..3."""
    p = jtfhe.get_params("test_insecure")
    rng = np.random.default_rng(2024)
    k, N, n = p.glwe_dimension, p.degree, p.lwe_dimension
    rows = (k + 1) * p.pbs_decomposer.levels
    kn = k * N
    lwe_sk = rng.integers(0, 2, size=n, dtype=np.uint32)
    glwe_sk = rng.integers(0, 2, size=(k, N), dtype=np.uint32)
    jsk = j_make_server_key(
        p, lwe_sk, glwe_sk, rnd_u32(rng, (n, rows, k, N)),
        gaussian_u32(rng, p.glwe_std_dev, (n, rows, N)),
        rnd_u32(rng, (kn * p.ks_decomposer.levels, n)),
        gaussian_u32(rng, p.lwe_std_dev, (kn * p.ks_decomposer.levels,)))
    tp = ttfhe.get_params("test_insecure")
    tck, tsk = keys_from_numpy(tp, lwe_sk, glwe_sk, np.asarray(jsk.bk_u32),
                               np.asarray(jsk.ksk_u32), device="cpu")
    msgs = np.arange(4, dtype=np.uint32)
    cts = np.asarray(jlwe.encrypt(lwe_sk, g.lwe_encode(msgs, p), rnd_u32(rng, (4, n)),
                                  gaussian_u32(rng, p.lwe_std_dev, (4,))))
    return p, jsk, tp, tck, tsk, cts, msgs


@pytest.mark.parametrize("impl", ["conv", "matmul", "pallas", "fused"])
def test_pbs_matches_jax_conv(insecure, impl):
    p, jsk, tp, tck, tsk, cts, msgs = insecure
    tv = jtv.identity_test_vector(p)
    want = jboot.pbs(p, jnp.asarray(cts), jsk, jnp.asarray(tv), impl="conv")
    got = tboot.pbs(tp, to_torch_u32(cts), tsk, to_torch_u32(ttv.identity_test_vector(tp)),
                    impl=impl)
    assert np.array_equal(to_numpy_u32(got), np.asarray(want))
    assert np.array_equal(to_numpy_u32(ttfhe.decrypt(tck, got)), msgs)


def test_pbs_fusedb_matches_jax_interpret_nano():
    """The balanced-digit kernel's plain twin through the whole PBS, against
    the Pallas kernel in interpret mode, with a JAX-generated key."""
    p = jtfhe.get_params("nano")
    jck, jsk = jax.jit(lambda s: jtfhe.keygen(p, s))(jax.random.key(3))
    cts = jtfhe.encrypt(jck, np.arange(6, dtype=np.uint32) % 4, key=9)
    tv = jnp.asarray(jtv.identity_test_vector(p))
    want = jboot.pbs(p, cts, jsk, tv, impl="fusedb_interpret")
    tp = ttfhe.get_params("nano")
    tck, tsk = keys_from_numpy(tp, np.asarray(jck.lwe_sk), np.asarray(jck.glwe_sk),
                               np.asarray(jsk.bk_u32), np.asarray(jsk.ksk_u32), device="cpu")
    got = tboot.pbs(tp, to_torch_u32(np.asarray(cts)), tsk, to_torch_u32(np.asarray(tv)),
                    impl="fusedb")
    assert np.array_equal(to_numpy_u32(got), np.asarray(want))
    assert np.array_equal(to_numpy_u32(ttfhe.decrypt(tck, got)), np.arange(6) % 4)


def test_gate_truth_tables_through_port():
    p = ttfhe.get_params("test_insecure")
    ck, sk = ttfhe.keygen(p, torch.Generator().manual_seed(11), device="cpu")
    a = ttfhe.encrypt(ck, BITS_A, 1)
    b = ttfhe.encrypt(ck, BITS_B, 2)
    for name, fn in (("nand", ttfhe.gates.nand), ("and", ttfhe.gates.and_),
                     ("or", ttfhe.gates.or_), ("xor", ttfhe.gates.xor)):
        want = np.array([jtv.GATE_FNS[name](int(x), int(y)) for x, y in zip(BITS_A, BITS_B)])
        got = to_numpy_u32(ttfhe.decrypt(ck, fn(sk, a, b)))
        assert np.array_equal(got, want), name
    assert np.array_equal(to_numpy_u32(ttfhe.decrypt(ck, ttfhe.gates.not_(sk, a))), 1 - BITS_A)


def test_jax_key_gives_same_gate_ciphertexts(insecure):
    p = jtfhe.get_params("test_insecure")
    jck, jsk = jtfhe.keygen(p, jax.random.key(7))
    a = jtfhe.encrypt(jck, BITS_A, key=1)
    b = jtfhe.encrypt(jck, BITS_B, key=2)
    want = np.asarray(jtfhe.gates.nand(jsk, a, b, impl="conv"))
    tck, tsk = keys_from_numpy(ttfhe.get_params("test_insecure"), np.asarray(jck.lwe_sk),
                               np.asarray(jck.glwe_sk), np.asarray(jsk.bk_u32),
                               np.asarray(jsk.ksk_u32), device="cpu")
    ta, tb = to_torch_u32(np.asarray(a)), to_torch_u32(np.asarray(b))
    for impl in ("conv", "matmul", "fused"):
        got = ttfhe.gates.nand(tsk, ta, tb, impl=impl)
        assert np.array_equal(to_numpy_u32(got), want), impl
    assert np.array_equal(to_numpy_u32(ttfhe.decrypt(tck, got)), 1 - (BITS_A & BITS_B))
