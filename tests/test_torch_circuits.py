"""The port's circuits layer (``models/circuits.py``) against the JAX package:
the same key and the same input ciphertexts give bit-identical ciphertexts
out of every stage (tolerance 0).  The JAX side runs its ``conv`` scan; the
port runs its plain scan and the latency path's twin (``fusedl``)."""

import jax
import numpy as np
import pytest
import torch

import tfhe_tpu as jtfhe
from tfhe_tpu.models import boolean as jbool
from tfhe_tpu.models import circuits as jcirc
from tfhe_tpu_torch.models import circuits as tcirc
from tfhe_tpu_torch.models.boolean import decrypt as tdecrypt
from tfhe_tpu_torch.models import keys as tkeys
from tfhe_tpu_torch.ops.torus import to_numpy_u32, to_torch_u32
from tfhe_tpu_torch.params import get_params as t_get_params

W, BATCH = 4, 2  # W*B = 8 ciphertexts per wide call: the fusedl cap


@pytest.fixture(scope="module", params=["nano", "nano_3in"])
def env(request):
    """A JAX key carried into the port, and W-bit inputs encrypted by JAX."""
    name = request.param
    p = jtfhe.get_params(name)
    jck, jsk = jtfhe.keygen(p, jax.random.key(21))
    tck, tsk = tkeys.keys_from_numpy(t_get_params(name), np.asarray(jck.lwe_sk),
                                     np.asarray(jck.glwe_sk), np.asarray(jsk.bk_u32),
                                     np.asarray(jsk.ksk_u32), device="cpu")
    tsk = tkeys.with_latency_key(tsk)
    rng = np.random.default_rng(22)
    a = rng.integers(0, 1 << W, size=BATCH).astype(np.uint32)
    b = rng.integers(0, 1 << W, size=BATCH).astype(np.uint32)
    ja = jcirc.encrypt_uint(jck, a, W, key=4)
    jb = jcirc.encrypt_uint(jck, b, W, key=5)
    trace = []
    want = jcirc.ripple_carry_add(jsk, ja, jb, impl="conv", trace=trace)
    return name, jck, jsk, tck, tsk, a, b, ja, jb, want, trace


def same(torch_u32, jax_u32) -> bool:
    return np.array_equal(to_numpy_u32(torch_u32), np.asarray(jax_u32, np.uint32))


@pytest.mark.parametrize("impl", ["matmul", "fusedl"])
def test_ripple_carry_add_matches_jax(env, impl):
    name, jck, jsk, tck, tsk, a, b, ja, jb, (jsum, jcout), jtrace = env
    trace = []
    s, cout = tcirc.ripple_carry_add(tsk, to_torch_u32(np.asarray(ja)),
                                     to_torch_u32(np.asarray(jb)), impl=impl, trace=trace)
    assert same(s, jsum) and same(cout, jcout)
    assert [(lbl, depth) for lbl, depth, *_ in trace] == [
        (lbl, depth) for lbl, depth, *_ in jtrace]
    for (lbl, _, cts, clear_fn), (_, _, jcts, _) in zip(trace, jtrace):
        assert same(cts, jcts), lbl
        got = to_numpy_u32(tdecrypt(tck, cts))
        assert np.array_equal(got, np.asarray(clear_fn(a, b, 0), np.uint32)), lbl
    assert np.array_equal(to_numpy_u32(tcirc.decrypt_uint(tck, s)), (a + b) % (1 << W))
    assert np.array_equal(to_numpy_u32(tdecrypt(tck, cout)), (a + b) >> W)


def test_add_uint_and_full_adder_match_jax(env):
    name, jck, jsk, tck, tsk, a, b, ja, jb, (jsum, _), _ = env
    got = tcirc.add_uint(tsk, to_torch_u32(np.asarray(ja)), to_torch_u32(np.asarray(jb)))
    assert same(got, jsum)
    bits = [np.array([i >> k & 1 for i in range(8)], np.uint32) for k in (2, 1, 0)]
    jcts = [jbool.encrypt(jck, x, key=30 + k) for k, x in enumerate(bits)]
    js, jc = jcirc.full_adder(jsk, *jcts, impl="conv")
    ts, tc = tcirc.full_adder(tsk, *(to_torch_u32(np.asarray(c)) for c in jcts))
    assert same(ts, js) and same(tc, jc)
    total = bits[0] + bits[1] + bits[2]
    assert np.array_equal(to_numpy_u32(tdecrypt(tck, ts)), total & 1)
    assert np.array_equal(to_numpy_u32(tdecrypt(tck, tc)), total >> 1)


def test_encrypt_decrypt_uint_and_trivial_bit(env):
    name, jck, jsk, tck, tsk, *_ = env
    vals = np.array([0, 1, 200, 255], np.uint32)
    bits = tcirc.encrypt_uint(tck, vals, 8, 9)
    assert bits.shape[:2] == (8, 4)
    assert np.array_equal(to_numpy_u32(tcirc.decrypt_uint(tck, bits)), vals)
    jbits = jcirc.encrypt_uint(jck, vals, 8, key=9)
    assert np.array_equal(to_numpy_u32(tcirc.decrypt_uint(tck, to_torch_u32(np.asarray(jbits)))),
                          np.asarray(jcirc.decrypt_uint(jck, jbits)))
    for v in (0, 1):
        assert same(tcirc.trivial_bit(tsk.params, (3,), v),
                    jcirc.trivial_bit(jsk.params, (3,), v))


def test_fusedl_adder_is_capped_by_wide_calls():
    """A W=8 add through fusedl carries 8*B ciphertexts per wide call: B=1
    fits the cap of 8, B=2 raises, as in the JAX package."""
    p = t_get_params("nano")
    ck, sk = tkeys.keygen(p, 23, device="cpu")
    sk = tkeys.with_latency_key(sk)
    a = tcirc.encrypt_uint(ck, [200], 8, 1)
    b = tcirc.encrypt_uint(ck, [100], 8, 2)
    s = tcirc.add_uint(sk, a, b, impl="fusedl")
    assert to_numpy_u32(tcirc.decrypt_uint(ck, s)).tolist() == [44]
    two = tcirc.encrypt_uint(ck, [1, 2], 8, 3)
    with pytest.raises(ValueError, match="B <= 8"):
        tcirc.add_uint(sk, two, two, impl="fusedl")
    assert torch.equal(tcirc.trivial_bit(p, (2,), 1)[:, :-1], torch.zeros((2, p.n), dtype=torch.int32))
