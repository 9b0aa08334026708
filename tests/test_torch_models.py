"""The port's models layer against the JAX package at test_insecure, with the
keygen and encryption randomness injected from numpy into both (the fixture
of tests/test_models.py).  Every comparison is bit-exact u32 equality."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_tpu.golden.model as g
from tfhe_tpu.models import bootstrap as jboot
from tfhe_tpu.models import ggsw as jggsw
from tfhe_tpu.models import glwe as jglwe
from tfhe_tpu.models import keyswitch as jks
from tfhe_tpu.models import lwe as jlwe
from tfhe_tpu.models.keys import ClientKey as JClientKey
from tfhe_tpu.models.keys import make_server_key as j_make_server_key
from tfhe_tpu.params import get_params
from tfhe_tpu.utils import noise as jnoise
from tfhe_tpu_torch.models import bootstrap as tboot
from tfhe_tpu_torch.models import ggsw as tggsw
from tfhe_tpu_torch.models import glwe as tglwe
from tfhe_tpu_torch.models import keyswitch as tks
from tfhe_tpu_torch.models import lwe as tlwe
from tfhe_tpu_torch.models.keys import ClientKey, keygen, keys_from_numpy, make_server_key
from tfhe_tpu_torch.ops.torus import to_numpy_u32, to_torch_u32
from tfhe_tpu_torch.params import get_params as t_get_params
from tfhe_tpu_torch.utils import noise as tnoise

JP = get_params("test_insecure")
TP = t_get_params("test_insecure")


def rnd_u32(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


def gaussian_u32(rng, std, shape):
    return g.f64_to_torus(rng.normal(0.0, std, size=shape))


def same(torch_u32, jax_u32) -> bool:
    return np.array_equal(to_numpy_u32(torch_u32), np.asarray(jax_u32, np.uint32))


@pytest.fixture(scope="module")
def shared():
    """Keys and keygen randomness shared between the JAX package and the port."""
    rng = np.random.default_rng(2024)
    p = JP
    k, N, n = p.glwe_dimension, p.degree, p.lwe_dimension
    rows = (k + 1) * p.pbs_decomposer.levels
    kn = k * N
    d = dict(
        lwe_sk=rng.integers(0, 2, size=n, dtype=np.uint32),
        glwe_sk=rng.integers(0, 2, size=(k, N), dtype=np.uint32),
        bk_a=rnd_u32(rng, (n, rows, k, N)),
        bk_e=gaussian_u32(rng, p.glwe_std_dev, (n, rows, N)),
        ksk_a=rnd_u32(rng, (kn * p.ks_decomposer.levels, n)),
        ksk_e=gaussian_u32(rng, p.lwe_std_dev, (kn * p.ks_decomposer.levels,)),
    )
    jsk = j_make_server_key(p, d["lwe_sk"], d["glwe_sk"], d["bk_a"], d["bk_e"],
                            d["ksk_a"], d["ksk_e"])
    tsk = make_server_key(TP, *(to_torch_u32(d[f]) for f in
                                ("lwe_sk", "glwe_sk", "bk_a", "bk_e", "ksk_a", "ksk_e")))
    return d, jsk, tsk


def test_make_server_key_matches(shared):
    _, jsk, tsk = shared
    assert same(tsk.bk_u32, jsk.bk_u32)
    assert same(tsk.bk_lm, jsk.bk_lm)
    assert same(tsk.ksk_u32, jsk.ksk_u32)
    assert np.array_equal(tsk.ksk_mat.numpy(), np.asarray(jsk.ksk_mat))
    assert tsk.device == torch.device("cpu") and tsk.to("cpu").bk_u32 is not None


def test_keys_from_numpy_matches_make_server_key(shared):
    d, jsk, tsk = shared
    ck, sk = keys_from_numpy(TP, d["lwe_sk"], d["glwe_sk"], np.asarray(jsk.bk_u32),
                             np.asarray(jsk.ksk_u32), device="cpu")
    for f in ("bk_u32", "bk_lm", "ksk_u32", "ksk_mat"):
        assert torch.equal(getattr(sk, f), getattr(tsk, f)), f
    assert same(ck.lwe_sk, d["lwe_sk"]) and same(ck.glwe_sk, d["glwe_sk"])


def test_keys_default_to_the_card():
    """keygen and keys_from_numpy put the keys on the card unless the caller
    asks for another device.  Without a card, a call without ``device=``
    raises torch's own error instead of carrying on on the CPU; with one,
    the keys land there with the bits an int seed gives on the CPU."""
    for fn in (keygen, keys_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    p = t_get_params("nano")
    ck_cpu, sk_cpu = keygen(p, 0, device="cpu")
    assert ck_cpu.device.type == "cpu" and sk_cpu.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            keygen(p, 0)
        with pytest.raises((AssertionError, RuntimeError)):
            keys_from_numpy(p, to_numpy_u32(ck_cpu.lwe_sk), to_numpy_u32(ck_cpu.glwe_sk),
                            to_numpy_u32(sk_cpu.bk_u32), to_numpy_u32(sk_cpu.ksk_u32))
        return
    ck, sk = keygen(p, 0)
    assert ck.device.type == "cuda" and sk.device.type == "cuda"
    assert torch.equal(sk.bk_u32.cpu(), sk_cpu.bk_u32)


def test_lwe_encrypt_decrypt(shared):
    d, *_ = shared
    rng = np.random.default_rng(7)
    a = rnd_u32(rng, (5, JP.lwe_dimension))
    e = gaussian_u32(rng, JP.lwe_std_dev, (5,))
    pt = g.lwe_encode(np.arange(5, dtype=np.uint32) % 4, JP)
    ours = tlwe.encrypt(to_torch_u32(d["lwe_sk"]), to_torch_u32(pt), to_torch_u32(a),
                        to_torch_u32(e))
    want = jlwe.encrypt(d["lwe_sk"], pt, a, e)
    assert same(ours, want)
    assert same(tlwe.decrypt(to_torch_u32(d["lwe_sk"]), ours), jlwe.decrypt(d["lwe_sk"], want))
    assert same(tlwe.scalar_mul(tlwe.add(ours, ours), 3),
                jlwe.scalar_mul(jlwe.add(want, want), 3))


def test_glwe_encrypt_decrypt_monomial_decompose(shared):
    d, *_ = shared
    rng = np.random.default_rng(8)
    k, N = JP.glwe_dimension, JP.degree
    a = rnd_u32(rng, (2, k, N))
    e = gaussian_u32(rng, JP.glwe_std_dev, (2, N))
    pt = rng.integers(0, 4, size=(2, N), dtype=np.uint32) * np.uint32(JP.delta)
    t_skt = tglwe.sk_toeplitz(to_torch_u32(d["glwe_sk"]))
    j_skt = jglwe.sk_toeplitz(d["glwe_sk"])
    assert np.array_equal(t_skt.numpy(), np.asarray(j_skt))
    ours = tglwe.encrypt(t_skt, to_torch_u32(pt), to_torch_u32(a), to_torch_u32(e))
    want = jglwe.encrypt(j_skt, pt, a, e)
    assert same(ours, want)
    assert same(tglwe.decrypt(t_skt, ours), jglwe.decrypt(j_skt, want))
    assert same(tglwe.trivial_encrypt(to_torch_u32(pt), k), jglwe.trivial_encrypt(pt, k))
    for exp in (-700, -1, 0, 3, 511, 512, 1023):
        assert same(tglwe.mul_monomial(ours, exp), jglwe.mul_monomial(want, exp)), exp
    assert np.array_equal(tglwe.decompose(ours, TP.pbs_decomposer).numpy(),
                          np.asarray(jglwe.decompose(want, JP.pbs_decomposer)))


def test_ggsw_external_product_and_cmux(shared):
    d, jsk, tsk = shared
    rng = np.random.default_rng(10)
    ct0 = rnd_u32(rng, (3, JP.glwe_dimension + 1, JP.degree))
    ct1 = rnd_u32(rng, (3, JP.glwe_dimension + 1, JP.degree))
    assert np.array_equal(tggsw.gadget_matrix(TP), jggsw.gadget_matrix(JP))
    for i in range(JP.lwe_dimension):
        ours = tggsw.external_product(tsk.bk_u32[i], to_torch_u32(ct0), TP)
        want = jggsw.external_product(jsk.bk_u32[i], ct0, JP, impl="conv")
        assert same(ours, want), i
    ours = tggsw.cmux(tsk.bk_u32[1], to_torch_u32(ct0), to_torch_u32(ct1), TP)
    want = jggsw.cmux(jsk.bk_u32[1], ct0, ct1, JP, impl="conv")
    assert same(ours, want)


def test_key_switch(shared):
    d, jsk, tsk = shared
    rng = np.random.default_rng(11)
    from_n = JP.glwe_dimension * JP.degree
    ct = rnd_u32(rng, (4, from_n + 1))
    ours = tks.key_switch(to_torch_u32(ct), from_n, TP.ks_decomposer, tsk.ksk_mat)
    want = jks.key_switch(ct, from_n, JP.ks_decomposer, jsk.ksk_mat)
    assert same(ours, want)
    assert same(tks.ksk_to_matmul(tsk.ksk_u32).to(torch.int32),
                np.asarray(jks.ksk_to_matmul(jsk.ksk_u32)).astype(np.int32))


def test_sample_extract(shared):
    rng = np.random.default_rng(17)
    ct = rnd_u32(rng, (3, JP.glwe_dimension + 1, JP.degree))
    t = to_torch_u32(ct)
    assert same(tboot.sample_extract0(t), jboot.sample_extract0(ct))
    for idx in (0, 1, 17, JP.degree // 2, JP.degree - 1):
        assert same(tboot.sample_extract(t, idx), jboot.sample_extract(ct, idx)), idx
    per = np.array([3, 500, 0], dtype=np.int32)
    assert same(tboot.sample_extract(t, torch.from_numpy(per)), jboot.sample_extract(ct, per))


def test_init_acc(shared):
    rng = np.random.default_rng(12)
    approx = rng.integers(0, 2 * JP.degree, size=(5, JP.lwe_dimension + 1), dtype=np.uint32)
    tv = rnd_u32(rng, (JP.degree,))
    t_acc, t_a = tboot._init_acc(TP, to_torch_u32(approx), to_torch_u32(tv))
    j_acc, j_a = jboot._init_acc(JP, jnp.asarray(approx), jnp.asarray(tv))
    assert same(t_acc, j_acc)
    assert np.array_equal(t_a.numpy(), np.asarray(j_a))


def test_noise_metering(shared):
    d, *_ = shared
    rng = np.random.default_rng(13)
    msgs = np.arange(6, dtype=np.uint32) % 4
    a = rnd_u32(rng, (6, JP.lwe_dimension))
    # errors up to +-0.6 Delta: some samples fail the decode threshold
    e = (rng.integers(-6, 7, size=6) * (JP.delta // 10)).astype(np.int64).astype(np.uint32)
    cts = jlwe.encrypt(d["lwe_sk"], g.lwe_encode(msgs, JP), a, e)
    jck = JClientKey(lwe_sk=jnp.asarray(d["lwe_sk"]), glwe_sk=jnp.asarray(d["glwe_sk"]),
                     params=JP)
    tck = ClientKey(lwe_sk=to_torch_u32(d["lwe_sk"]), glwe_sk=to_torch_u32(d["glwe_sk"]),
                    params=TP)
    t_cts = to_torch_u32(np.asarray(cts))
    assert np.array_equal(tnoise.centered_error(tck, t_cts, msgs),
                          jnoise.centered_error(jck, cts, msgs))
    assert dataclasses_equal(tnoise.measure(tck, t_cts, msgs), jnoise.measure(jck, cts, msgs))


def dataclasses_equal(a, b) -> bool:
    return (a.max_abs_over_delta, a.mean_abs_over_delta, a.failures, a.count) == (
        b.max_abs_over_delta, b.mean_abs_over_delta, b.failures, b.count)


def test_resolve_impl():
    assert tboot.resolve_impl("auto", "cpu") == "matmul"
    assert tboot.resolve_impl("auto", torch.device("cuda")) == "pallas"
    assert tboot.resolve_impl("fusedb", "cpu") == "fusedb"
    assert tboot.resolve_impl("conv", "cpu") == "conv"  # Kernel H's scan
    with pytest.raises(ValueError):
        tboot.resolve_impl("conv_interpret", "cpu")  # JAX-only interpret mode
