"""The gates' device cache of encoded test vectors
(``models/test_vector.py:on_device``): one tensor per (params, device, kind,
arguments), the same output words as a test vector built afresh, left
unwritten by a whole add, and counted as uploads and hits.

CPU cases at ``nano`` and ``nano_3in`` on the plain twins.  Each test clears
the cache first, so the order in which the files run does not matter.  The
file imports neither JAX nor tfhe_tpu:

    python -m pytest tests/test_torch_test_vector_cache.py -q -o addopts= --noconftest
"""

import itertools

import pytest
import torch

import tfhe_tpu_torch as tfhe
from tfhe_tpu_torch.models import bootstrap as mboot
from tfhe_tpu_torch.models import boolean as mbool
from tfhe_tpu_torch.models import lwe as mlwe
from tfhe_tpu_torch.models import test_vector as mtv
from tfhe_tpu_torch.ops.torus import to_torch_u32
from tfhe_tpu_torch.utils import profiling as prof

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def empty_cache():
    mtv.clear_device_cache()
    yield
    mtv.clear_device_cache()


@pytest.fixture(scope="module")
def keys():
    """(client key, server key, three ciphertexts) at a named parameter set."""
    made = {}

    def get(name):
        if name not in made:
            ck, sk = tfhe.keygen(tfhe.get_params(name), 5, device="cpu")
            made[name] = (ck, sk, *(tfhe.encrypt(ck, bits, seed) for bits, seed in
                                    (([0, 0, 1, 1], 1), ([0, 1, 0, 1], 2), ([1, 0, 0, 1], 3))))
        return made[name]

    return get


@pytest.mark.parametrize("key, other", [
    (("gate", "xor"), ("gate", "and")),
    (("lut", (1, 0, 1, 0)), ("lut", (0, 1, 1, 0))),
    (("identity",), ("gate", "xor")),
    (("gate3", "maj"), ("gate3", "xor3")),
])
def test_the_cache_keeps_one_tensor_a_key(key, other):
    params = tfhe.get_params("nano_3in" if key[0] == "gate3" else "nano")
    tv = mtv.on_device(params, CPU, *key)
    assert tv.dtype == torch.int32 and tv.shape == (params.degree,)
    assert mtv.on_device(params, CPU, *key) is tv
    assert mtv.on_device(params, CPU, *other) is not tv
    assert torch.equal(tv, to_torch_u32(mtv.ENCODERS[key[0]](params, *key[1:])))


def test_the_cache_is_bounded():
    params = tfhe.get_params("nano")  # log_p = 2: 4^4 = 256 distinct LUTs
    first = mtv.on_device(params, CPU, "gate", "xor")
    luts = list(itertools.product(range(4), repeat=4))
    assert len(luts) >= mtv.DEVICE_CACHE_SIZE
    for lut in luts[:mtv.DEVICE_CACHE_SIZE]:
        mtv.on_device(params, CPU, "lut", lut)
    last = mtv.on_device(params, CPU, "lut", luts[mtv.DEVICE_CACHE_SIZE - 1])
    assert mtv.on_device(params, CPU, "lut", luts[mtv.DEVICE_CACHE_SIZE - 1]) is last
    assert mtv.on_device(params, CPU, "gate", "xor") is not first  # the oldest went


def test_no_cache_of_the_module_outgrows_the_device_cache():
    """300 distinct LUTs through ``on_device``: no cache in
    ``models/test_vector.py`` holds more than ``DEVICE_CACHE_SIZE`` entries
    (the numpy encoders keep no cache of their own)."""
    params = tfhe.get_params("nano_3in")  # log_p = 3: 8^8 distinct LUTs
    for lut in itertools.islice(itertools.product(range(8), repeat=8), 300):
        mtv.on_device(params, CPU, "lut", lut)
    sizes = {name: f.cache_info().currsize for name, f in vars(mtv).items()
             if hasattr(f, "cache_info")}
    assert sizes["_on_device"] == mtv.DEVICE_CACHE_SIZE
    assert max(sizes.values()) <= mtv.DEVICE_CACHE_SIZE, sizes


def _reversed_lut(p):
    return tuple(range(1 << p.log_p))[::-1]


#: each gate entry point: (its call, its PBS input, its encoded test vector)
OPS = {
    "gate": lambda sk, a, b, c, impl: (
        mbool.gate(sk, "nand", a, b, impl=impl), mlwe.add(mlwe.scalar_mul(b, 2), a),
        mtv.gate_test_vector(sk.params, "nand")),
    "apply_lut": lambda sk, a, b, c, impl: (
        mbool.apply_lut(sk, a, list(_reversed_lut(sk.params)), impl=impl), a,
        mtv.lut_test_vector(sk.params, _reversed_lut(sk.params))),
    "bootstrap_identity": lambda sk, a, b, c, impl: (
        mbool.bootstrap_identity(sk, a, impl=impl), a, mtv.identity_test_vector(sk.params)),
    "gate3": lambda sk, a, b, c, impl: (
        mbool.gate3(sk, "maj", c, b, a, impl=impl),
        mlwe.add(mlwe.add(mlwe.scalar_mul(c, 4), mlwe.scalar_mul(b, 2)), a),
        mtv.gate3_test_vector(sk.params, "maj")),
}


@pytest.mark.parametrize("impl", ["matmul", "fused"])
@pytest.mark.parametrize("params, op", [("nano", "gate"), ("nano", "apply_lut"),
                                        ("nano", "bootstrap_identity"), ("nano_3in", "gate"),
                                        ("nano_3in", "gate3")])
def test_a_cached_test_vector_gives_the_words_of_a_fresh_one(keys, params, op, impl):
    _, sk, a, b, c = keys(params)
    got, ct_in, encoded = OPS[op](sk, a, b, c, impl)  # a miss: the cache fills
    want = mboot.pbs(sk.params, ct_in, sk, to_torch_u32(encoded), impl=impl)
    assert torch.equal(got, want)
    again, _, _ = OPS[op](sk, a, b, c, impl)  # a hit
    assert torch.equal(again, want)


@pytest.fixture(scope="module")
def add8():
    """An 8-bit add at nano: 19 PBS calls, as the benchmark's add."""
    params = tfhe.get_params("nano")
    ck, sk = tfhe.keygen(params, 5, device="cpu")
    a = tfhe.circuits.encrypt_uint(ck, [200, 17], 8, 3)
    b = tfhe.circuits.encrypt_uint(ck, [100, 250], 8, 4)

    def add():
        return tfhe.circuits.ripple_carry_add(sk, a, b, impl="fused")

    return ck, sk, add


def test_an_add_leaves_its_cached_test_vectors_as_they_were(add8):
    ck, sk, add = add8
    cached = {g: mtv.on_device(sk.params, CPU, "gate", g) for g in ("xor", "and", "or")}
    before = {g: tv.clone() for g, tv in cached.items()}
    s, c = add()
    assert tfhe.circuits.decrypt_uint(ck, s).tolist() == [44, 11]
    assert tfhe.decrypt(ck, c).tolist() == [1, 1]
    for g, tv in cached.items():
        assert mtv.on_device(sk.params, CPU, "gate", g) is tv
        assert torch.equal(tv, before[g])


def test_a_cold_add_uploads_three_test_vectors_and_a_warm_one_none(add8):
    _, _, add = add8
    counts = []
    for _ in range(2):
        prof.reset()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            add()
        counts.append(prof.counters())
    cold, warm = counts
    assert cold["pbs.calls"] == warm["pbs.calls"] == 19
    assert cold["pbs.test_vector_uploads"] == 3 and cold["pbs.test_vector_hits"] == 16
    assert "pbs.test_vector_uploads" not in warm and warm["pbs.test_vector_hits"] == 19
    assert "pbs.card_waits" not in cold  # a CPU key: nothing is copied to a card
