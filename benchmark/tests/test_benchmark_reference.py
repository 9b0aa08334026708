"""The plain reference against the program's CPU twins, word for word: the
keys, every gate and the ripple-carry adder at nano and test_insecure.  The
test imports both; the reference imports nothing of the program."""

from __future__ import annotations

import pytest
import torch

import tfhe_tpu_torch as tfhe
from benchmark.benchlib import roofline, runner, spec
from benchmark.reference import tfhe_ref as ref
from benchmark.tests.cells import small_config

GATE_NAMES = sorted(ref.GATES)


def _keys(name: str, seed: int):
    p = ref.params_from_config(name, small_config(name))
    draws = ref.draw_keys(p, torch.Generator().manual_seed(seed))
    carried = [ref.to_carrier(x) for x in (draws.lwe_sk, draws.glwe_sk, draws.bk_a,
                                           draws.bk_e, draws.ksk_a, draws.ksk_e)]
    sk = tfhe.make_server_key(runner.program_params(p), *carried)
    return p, draws, ref.derive_keys(p, draws), sk


@pytest.mark.parametrize("name", ["nano", "test_insecure"])
def test_reference_keys_equal_the_programs(name):
    p, _, keys, sk = _keys(name, 3)
    assert torch.equal(ref.from_carrier(sk.bk_u32), keys.bk)
    assert torch.equal(ref.from_carrier(sk.ksk_u32), keys.ksk)


@pytest.mark.parametrize("name,impl", [("nano", "fusedp"), ("nano", "fusedl"),
                                       ("test_insecure", "fusedp"),
                                       ("test_insecure", "fusedl")])
def test_reference_gates_equal_the_programs(name, impl):
    p, draws, keys, sk = _keys(name, 5)
    sk = tfhe.with_key_form(sk, impl)
    gen = torch.Generator().manual_seed(9)
    batch = 4 if impl == "fusedp" else 8
    lhs, rhs = ref.bits(gen, (batch,)), ref.bits(gen, (batch,))
    ct1 = ref.encrypt_bits(p, gen, draws.lwe_sk, lhs)
    ct0 = ref.encrypt_bits(p, gen, draws.lwe_sk, rhs)
    for gate in GATE_NAMES:
        got = tfhe.gates.gate(sk, gate, ref.to_carrier(ct0), ref.to_carrier(ct1), impl=impl)
        want = ref.gate(p, keys, gate, ct0, ct1)
        assert torch.equal(ref.from_carrier(got), want), gate
        assert torch.equal(ref.decrypt(p, draws.lwe_sk, want), ref.GATES[gate](lhs, rhs)), gate


def test_reference_gates_take_one_name_per_row():
    p, draws, keys, _ = _keys("nano", 6)
    gen = torch.Generator().manual_seed(1)
    ct0 = ref.encrypt_bits(p, gen, draws.lwe_sk, ref.bits(gen, (4,)))
    ct1 = ref.encrypt_bits(p, gen, draws.lwe_sk, ref.bits(gen, (4,)))
    names = ["and", "xor", "andny", "nor"]
    mixed = ref.gate(p, keys, names, ct0, ct1)
    for i, gate in enumerate(names):
        assert torch.equal(mixed[i], ref.gate(p, keys, gate, ct0[i:i + 1], ct1[i:i + 1])[0])


@pytest.mark.parametrize("name,impl", [("nano", "fusedl"), ("nano", "fusedp"),
                                       ("test_insecure", "fusedl")])
def test_reference_adder_equals_the_programs(name, impl):
    p, draws, keys, sk = _keys(name, 7)
    sk = tfhe.with_key_form(sk, impl)
    gen = torch.Generator().manual_seed(4)
    width, batch = 4, 2
    a = torch.randint(0, 1 << width, (batch,), generator=gen)
    b = torch.randint(0, 1 << width, (batch,), generator=gen)
    shifts = torch.arange(width)[:, None]
    ca = ref.encrypt_bits(p, gen, draws.lwe_sk, (a[None] >> shifts) & 1)
    cb = ref.encrypt_bits(p, gen, draws.lwe_sk, (b[None] >> shifts) & 1)
    s, c = tfhe.circuits.ripple_carry_add(sk, ref.to_carrier(ca), ref.to_carrier(cb), impl=impl)
    s_ref, c_ref = ref.ripple_add(p, keys, ca, cb)
    assert torch.equal(ref.from_carrier(s), s_ref)
    assert torch.equal(ref.from_carrier(c), c_ref)
    total = a + b
    bits = (total[None] >> torch.arange(width + 1)[:, None]) & 1
    assert torch.equal(ref.decrypt(p, draws.lwe_sk, torch.cat([s_ref, c_ref[None]])), bits)


def test_reference_decompose_reconstructs_the_rounded_value():
    gen = torch.Generator().manual_seed(0)
    v = ref.uniform_u32(gen, (4096,))
    v = torch.cat([v, torch.tensor([0, ref.MASK, 0x7FFFFFFF, 0x80000000, 0xFFFFFF80])])
    for log_base, levels in ((4, 6), (4, 5), (4, 8)):
        d = ref.decompose(v, log_base, levels)
        assert int(d.min()) >= -(1 << (log_base - 1)) and int(d.max()) <= 1 << log_base
        ignored = 32 - log_base * levels
        weights = torch.tensor([1 << (log_base * (levels - 1 - j) + ignored)
                                for j in range(levels)])
        rounded = (((v >> ignored) + ((v >> (ignored - 1)) & 1)) << ignored) & ref.MASK \
            if ignored else v
        assert torch.equal((d * weights).sum(-1) & ref.MASK, rounded)


def test_schoolbook_bound_of_default_128_and_of_n_2048():
    config = spec.read_json(spec.BENCH_DIR / "configs" / "default_128.json")
    d128 = ref.params_from_config("default_128", config)
    # the program's large_2048 profile: k=1, N=2048, the rest as default_128
    l2048 = ref.params_from_config("large_2048", dict(config, glwe_dimension=1, log_degree=11))
    card = "NVIDIA H100 80GB HBM3"
    assert round(roofline.bound_seconds(d128, 1024, card) * 1e3, 2) == 42.31
    assert round(roofline.bound_seconds(l2048, 256, card) * 1e3, 2) == 75.21
    assert roofline.bound_seconds(d128, 1024, "another card") is None
    # both are bound by the work, not the bytes
    assert roofline.rotation_bytes(d128, 1024) / 3.35e12 < 42.31e-3 / 10

