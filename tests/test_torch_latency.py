"""The small-batch latency path of the port (BMMP key, latency key operands,
``impl='fusedl'``/``'bmmpl'``/``'bmmp'``) against the JAX package.

Every comparison is bit-exact (tolerance 0, ``np.array_equal``).  The JAX
side runs its Pallas latency kernel in interpret mode at ``nano`` shapes, as
tests/test_models.py::TestKernelBitExactNano does; at ``test_insecure`` the
port's ``fusedl`` is held against the JAX ``conv`` scan, since the interpret
kernels cost minutes there.  On the CPU the port's kernel wrappers run their
plain twins.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_tpu as jtfhe
import tfhe_tpu.golden.model as g
from tfhe_tpu.models import bootstrap as jboot
from tfhe_tpu.models.keys import make_server_key as j_make_server_key
from tfhe_tpu.models.keys import with_latency_key as j_with_latency_key
from tfhe_tpu.ops.pallas import latency_kernel as jlatk
from tfhe_tpu_torch.models import bootstrap as tboot
from tfhe_tpu_torch.models import keys as tkeys
from tfhe_tpu_torch.ops import sampling
from tfhe_tpu_torch.ops.cuda import latency_kernel as latk
from tfhe_tpu_torch.ops.torus import to_numpy_u32, to_torch_u32
from tfhe_tpu_torch.params import get_params as t_get_params


def rnd_u32(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


def gaussian_u32(rng, std, shape):
    return g.f64_to_torus(rng.normal(0.0, std, size=shape))


def same(torch_u32, jax_u32) -> bool:
    return np.array_equal(to_numpy_u32(torch_u32), np.asarray(jax_u32, np.uint32))


def port_keys(jck, jsk, name):
    """The port's keys from the JAX package's arrays, BMMP triples included."""
    return tkeys.keys_from_numpy(
        t_get_params(name), np.asarray(jck.lwe_sk), np.asarray(jck.glwe_sk),
        np.asarray(jsk.bk_u32), np.asarray(jsk.ksk_u32),
        bk_bmmp_lm=np.asarray(jsk.bk_bmmp_lm), device="cpu")


# ---------------------------------------------------------------------------
# key operands
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["nano", "test_insecure"])
def test_latency_operands_byte_equal_to_jax(name):
    p = jtfhe.get_params(name)
    k1, n = p.glwe_dimension + 1, p.degree
    r = k1 * p.pbs_decomposer.levels
    rng = np.random.default_rng(90)
    bk = rnd_u32(rng, (3, r, k1, n))
    bk[0, 0, 0, :4] = [0, 2**31, 2**32 - 1, 0x80808080]
    bmmp = rnd_u32(rng, (2, 3 * r, k1, n))
    want = np.asarray(jlatk.bk_latency_operand(jnp.asarray(bk)))
    got = latk.bk_latency_operand(to_torch_u32(bk))
    assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)
    want = np.asarray(jlatk.bk_latency_operand_bmmp(jnp.asarray(bmmp), p))
    got = latk.bk_latency_operand_bmmp(to_torch_u32(bmmp), t_get_params(name))
    assert np.array_equal(got.numpy(), want)
    assert got.shape[-1] == 4 * latk.n_groups(t_get_params(name), 3) * n


def test_bmmp_key_and_latency_key_match_jax():
    """make_server_key's BMMP triples (injected randomness) and
    with_latency_key against the JAX package, at nano."""
    p = jtfhe.get_params("nano")
    rng = np.random.default_rng(91)
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
        bmmp_a=rnd_u32(rng, (3 * n // 2, rows, k, N)),
        bmmp_e=gaussian_u32(rng, p.glwe_std_dev, (3 * n // 2, rows, N)),
    )
    jsk = j_with_latency_key(j_make_server_key(p, *d.values()))
    tsk = tkeys.with_latency_key(tkeys.make_server_key(
        t_get_params("nano"), *(to_torch_u32(v) for v in d.values())))
    assert same(tsk.bk_u32, jsk.bk_u32) and same(tsk.bk_bmmp_lm, jsk.bk_bmmp_lm)
    assert np.array_equal(tsk.bk_lat.numpy(), np.asarray(jsk.bk_lat))
    assert np.array_equal(tsk.bk_bmmp_lat.numpy(), np.asarray(jsk.bk_bmmp_lat))
    moved = tsk.to("cpu")
    assert torch.equal(moved.bk_bmmp_lat, tsk.bk_bmmp_lat)
    plain = tkeys.make_server_key(t_get_params("nano"),
                                  *(to_torch_u32(d[f]) for f in list(d)[:6]))
    assert plain.bk_bmmp_lm is None and plain.to("cpu").bk_lat is None


def test_keygen_without_bmmp_is_unchanged():
    """keygen(bmmp=False) draws exactly what it drew before BMMP existed, and
    keygen(bmmp=True) draws the triples after them, so its other keys agree."""
    p = t_get_params("nano")
    k, N, n = p.glwe_dimension, p.degree, p.lwe_dimension
    rows = (k + 1) * p.pbs_decomposer.levels
    ks = p.ks_decomposer
    gen = torch.Generator().manual_seed(12)
    draws = [sampling.binary(gen, (n,)), sampling.binary(gen, (k, N)),
             sampling.uniform_u32(gen, (n, rows, k, N)),
             sampling.gaussian_torus(gen, p.glwe_std_dev, (n, rows, N)),
             sampling.uniform_u32(gen, (k * N * ks.levels, n)),
             sampling.gaussian_torus(gen, p.lwe_std_dev, (k * N * ks.levels,))]
    want = tkeys.make_server_key(p, *draws)
    ck0, sk0 = tkeys.keygen(p, 12, device="cpu")
    ck1, sk1 = tkeys.keygen(p, 12, device="cpu", bmmp=True)
    assert torch.equal(ck0.lwe_sk, draws[0]) and torch.equal(ck0.glwe_sk, draws[1])
    for f in ("bk_u32", "bk_lm", "ksk_u32", "ksk_mat"):
        assert torch.equal(getattr(sk0, f), getattr(want, f)), f
        assert torch.equal(getattr(sk1, f), getattr(want, f)), f
    assert sk0.bk_bmmp_lm is None
    assert sk1.bk_bmmp_lm.shape == (n // 2, 3 * rows, k + 1, N)


# ---------------------------------------------------------------------------
# blind rotation: fusedl, bmmpl, bmmp against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nano_env():
    """A JAX nano key with BMMP triples and latency operands, carried into the
    port, and the JAX interpret-mode rotations at the batches under test."""
    p = jtfhe.get_params("nano")
    jck, jsk = jtfhe.keygen(p, jax.random.key(5), bmmp=True)
    jsk = j_with_latency_key(jsk)
    _, tsk = port_keys(jck, jsk, "nano")
    tsk = tkeys.with_latency_key(tsk)
    rng = np.random.default_rng(77)
    approx = rng.integers(0, 2 * p.degree, size=(8, p.lwe_dimension + 1), dtype=np.uint32)
    tv = rnd_u32(rng, (p.degree,))
    refs = {}
    for impl, batch in (("fusedl", 8), ("fusedl", 3), ("bmmpl", 4), ("bmmpl", 3),
                        ("bmmp", 4), ("bmmp", 3)):
        refs[impl, batch] = np.asarray(jboot.blind_rotate(
            p, jnp.asarray(approx[:batch]), jsk, jnp.asarray(tv), impl=f"{impl}_interpret"))
    return tsk, approx, tv, refs


@pytest.mark.parametrize("impl,batch", [("fusedl", 8), ("fusedl", 3), ("bmmpl", 4),
                                        ("bmmpl", 3), ("bmmp", 4), ("bmmp", 3)])
def test_blind_rotate_matches_jax_interpret_nano(nano_env, impl, batch):
    tsk, approx, tv, refs = nano_env
    got = tboot.blind_rotate(t_get_params("nano"), to_torch_u32(approx[:batch]), tsk,
                             to_torch_u32(tv), impl=impl)
    assert same(got, refs[impl, batch])


def test_latency_paths_without_cached_operands(nano_env):
    """Without with_latency_key the latency impls refuse the key, and attaching
    the operands afterwards gives the JAX rows."""
    tsk, approx, tv, refs = nano_env
    bare = dataclasses.replace(tsk, bk_lat=None, bk_bmmp_lat=None)
    p = t_get_params("nano")
    for impl, batch in (("fusedl", 3), ("bmmpl", 3)):
        with pytest.raises(ValueError, match="with_latency_key"):
            tboot.blind_rotate(p, to_torch_u32(approx[:batch]), bare, to_torch_u32(tv),
                               impl=impl)
        got = tboot.blind_rotate(p, to_torch_u32(approx[:batch]), tkeys.with_latency_key(bare),
                                 to_torch_u32(tv), impl=impl)
        assert same(got, refs[impl, batch]), impl


def test_fusedl_matches_jax_conv_test_insecure():
    p = jtfhe.get_params("test_insecure")
    jck, jsk = jtfhe.keygen(p, jax.random.key(6))
    tp = t_get_params("test_insecure")
    _, tsk = tkeys.keys_from_numpy(tp, np.asarray(jck.lwe_sk), np.asarray(jck.glwe_sk),
                                   np.asarray(jsk.bk_u32), np.asarray(jsk.ksk_u32),
                                   device="cpu")
    tsk = tkeys.with_latency_key(tsk)
    rng = np.random.default_rng(78)
    approx = rng.integers(0, 2 * p.degree, size=(3, p.lwe_dimension + 1), dtype=np.uint32)
    tv = rnd_u32(rng, (p.degree,))
    want = jboot.blind_rotate(p, jnp.asarray(approx), jsk, jnp.asarray(tv), impl="conv")
    got = tboot.blind_rotate(tp, to_torch_u32(approx), tsk, to_torch_u32(tv), impl="fusedl")
    assert same(got, want)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_latency_paths_refuse_what_they_do_not_serve(nano_env):
    tsk, approx, tv, _ = nano_env
    p = t_get_params("nano")
    rng = np.random.default_rng(79)
    big = to_torch_u32(rng.integers(0, 2 * p.degree, size=(9, p.lwe_dimension + 1)))
    tv_t = to_torch_u32(tv)
    with pytest.raises(ValueError, match="B <= 8"):
        tboot.blind_rotate(p, big, tsk, tv_t, impl="fusedl")
    with pytest.raises(ValueError, match="B <= 4"):
        tboot.blind_rotate(p, big[:5], tsk, tv_t, impl="bmmpl")
    no_bmmp = dataclasses.replace(tsk, bk_bmmp_lm=None, bk_bmmp_lat=None)
    for impl in ("bmmp", "bmmpl"):
        with pytest.raises(ValueError, match="BMMP key"):
            tboot.blind_rotate(p, big[:2], no_bmmp, tv_t, impl=impl)
    odd = dataclasses.replace(p, lwe_dimension=5)
    with pytest.raises(ValueError, match="even"):
        tkeys.keygen(odd, 0, device="cpu", bmmp=True)
    with pytest.raises(ValueError, match="V=1"):  # the wrapper checks the cap too
        latk.blind_rotate_latency(p, torch.zeros((9, 2, p.degree), dtype=torch.int32),
                                  tsk.bk_lat, torch.zeros((4, 1, 9), dtype=torch.int32))
    with pytest.raises(ValueError):
        latk.blind_rotate_latency(p, torch.zeros((1, 2, p.degree), dtype=torch.int32).to("meta"),
                                  tsk.bk_lat.to("meta"),
                                  torch.zeros((4, 1, 1), dtype=torch.int32).to("meta"))
    assert tboot.resolve_impl("auto", "cpu") == "matmul"
    assert {"fusedl", "bmmpl", "bmmp"} <= set(tboot.VALID_IMPLS)
    assert latk.KERNEL.launches == 0
