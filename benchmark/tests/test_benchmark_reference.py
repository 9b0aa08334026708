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
    for log_base, levels in ((4, 6), (4, 5), (4, 8), (7, 3)):  # 7 does not divide 32
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



def test_schoolbook_bound_of_default_128_at_b64():
    d128 = ref.params_from_config(
        "default_128", spec.read_json(spec.BENCH_DIR / "configs" / "default_128.json"))
    assert round(roofline.bound_seconds(d128, 64, "NVIDIA H100 80GB HBM3") * 1e3, 2) == 2.64


# ---------------------------------------------------------------------------
# the gadget and digits of any base, and the balanced digits
# ---------------------------------------------------------------------------


def _frozen_decompose(v, log_base, levels):
    """``decompose`` as it was written for bases that divide 32 alone."""
    half = 1 << (log_base - 1)
    ignored = 32 - log_base * levels
    if ignored:
        v = (((v + (1 << (ignored - 1))) & ref.MASK) >> ignored) << ignored
    shifts = torch.arange(32 // log_base - levels, 32 // log_base) * log_base
    x = (v[..., None] >> shifts) & ((1 << log_base) - 1)
    res, top, carry = [], [], 0
    for j in range(levels):
        r = x[..., j] + carry
        t = r & half
        carry = t >> (log_base - 1)
        res.append(r)
        top.append(t)
    return (torch.stack(res, dim=-1) - 2 * torch.stack(top, dim=-1)).flip(-1)


def _frozen_derive_keys(p, d):
    """``derive_keys`` as it was written for bases that divide 32 alone."""
    k = p.k
    body = (ref._glwe_mask_dot(d.bk_a, d.glwe_sk) + d.bk_e) & ref.MASK
    bk = torch.cat([d.bk_a, body[:, :, None, :]], dim=2)
    l_full = 32 // p.pbs_log_base
    for c in range(k + 1):
        for j in range(p.pbs_levels):
            g = 1 << (p.pbs_log_base * (l_full - j - 1))
            r = c * p.pbs_levels + j
            bk[:, r, c, 0] = (bk[:, r, c, 0] + d.lwe_sk * g) & ref.MASK
    ks_full = 32 // p.ks_log_base
    shifts = torch.tensor([p.ks_log_base * (ks_full - j - 1) for j in range(p.ks_levels)])
    factors = (d.glwe_sk.reshape(-1, 1) << shifts).reshape(-1)
    return ref.Keys(bk=bk, ksk=ref.lwe_encrypt_raw(d.lwe_sk, factors, d.ksk_a, d.ksk_e))


def _words():
    gen = torch.Generator().manual_seed(21)
    return torch.cat([ref.uniform_u32(gen, (8192,)),
                      torch.tensor([0, ref.MASK, 0x7FFFFFFF, 0x80000000, 0xFFFFFF80, 0x400])])


@pytest.mark.parametrize("log_base,levels", [(4, 6), (4, 5), (2, 8), (1, 16)])
def test_digits_of_a_base_that_divides_32_are_as_before(log_base, levels):
    v = _words()
    assert torch.equal(ref.decompose(v, log_base, levels), _frozen_decompose(v, log_base, levels))


@pytest.mark.parametrize("pbs,ks", [((4, 6), (4, 5)), ((2, 8), (1, 16)), ((4, 5), (2, 8))])
def test_keys_of_bases_that_divide_32_are_as_before(pbs, ks):
    cfg = dict(small_config("nano"), pbs_log_base=pbs[0], pbs_levels=pbs[1], ks_log_base=ks[0],
               ks_levels=ks[1])
    p = ref.params_from_config("nano", cfg)
    draws = ref.draw_keys(p, torch.Generator().manual_seed(8))
    keys, frozen = ref.derive_keys(p, draws), _frozen_derive_keys(p, draws)
    assert torch.equal(keys.bk, frozen.bk) and torch.equal(keys.ksk, frozen.ksk)


def _rounded(v, log_base, levels):
    ignored = 32 - log_base * levels
    return (((v >> ignored) + ((v >> (ignored - 1)) & 1)) << ignored) & ref.MASK if ignored \
        else v


def _recomposed(digits, log_base):
    levels = digits.shape[-1]
    weights = torch.tensor([1 << (32 - log_base * (j + 1)) for j in range(levels)])
    return (digits * weights).sum(-1) & ref.MASK


@pytest.mark.parametrize("log_base,levels", [(7, 3), (4, 6), (4, 5), (2, 8), (1, 16), (5, 5)])
def test_balanced_digits_lie_in_half_the_base_and_reconstruct(log_base, levels):
    v = _words()
    d = ref.decompose_balanced(v, log_base, levels)
    half = 1 << (log_base - 1)
    assert int(d.min()) >= -half and int(d.max()) < half
    assert torch.equal(_recomposed(d, log_base), _rounded(v, log_base, levels))


@pytest.mark.parametrize("log_base,levels", [(4, 6), (4, 5), (2, 8)])
def test_balanced_digits_equal_the_programs_closed_form(log_base, levels):
    from tfhe_tpu_torch.ops.decomposer import decompose_balanced_planes

    v = _words()
    planes = decompose_balanced_planes(ref.to_carrier(v),
                                       tfhe.DecomposerParams(log_base, levels, 32))
    assert torch.equal(ref.decompose_balanced(v, log_base, levels),
                       planes.to(torch.int64).movedim(0, -1))


def test_a_base_of_7_by_3_puts_the_secret_at_bits_25_18_11():
    cfg = dict(small_config("nano"), pbs_log_base=7, pbs_levels=3, pbs_digits="balanced")
    p = ref.params_from_config("nano", cfg)
    draws = ref.draw_keys(p, torch.Generator().manual_seed(12))
    draws.lwe_sk[:] = torch.tensor([1, 0, 1, 1])
    keys = ref.derive_keys(p, draws)
    zero = ref.derive_keys(p, ref.Draws(**dict(vars(draws), lwe_sk=torch.zeros_like(draws.lwe_sk))))
    added = (keys.bk - zero.bk) & ref.MASK  # [n, R, k+1, N]: what the secret bits put in
    want = torch.zeros_like(added)
    for c in range(p.k + 1):
        for j, bit in enumerate((25, 18, 11)):
            want[:, c * 3 + j, c, 0] = draws.lwe_sk << bit
    assert torch.equal(added, want)


def test_a_configuration_states_its_pbs_digits():
    cfg = small_config("nano")
    assert ref.params_from_config("nano", cfg).pbs_digits == "carry"
    assert ref.params_from_config("nano", dict(cfg, pbs_digits="balanced")).pbs_digits == \
        "balanced"
    with pytest.raises(ValueError, match="pbs_digits"):
        ref.params_from_config("nano", dict(cfg, pbs_digits="nearest"))


@pytest.mark.parametrize("name", ["nano", "test_insecure"])
def test_balanced_reference_gates_equal_the_programs_fusedb(name):
    p, draws, _, sk = _keys(name, 15)
    balanced = ref.params_from_config(name, dict(small_config(name), pbs_digits="balanced"))
    keys = ref.derive_keys(balanced, draws)
    gen = torch.Generator().manual_seed(16)
    ct1 = ref.encrypt_bits(p, gen, draws.lwe_sk, ref.bits(gen, (8,)))
    ct0 = ref.encrypt_bits(p, gen, draws.lwe_sk, ref.bits(gen, (8,)))
    carry_differs = False
    for gate in GATE_NAMES:
        got = ref.from_carrier(tfhe.gates.gate(sk, gate, ref.to_carrier(ct0), ref.to_carrier(ct1),
                                               impl="fusedb"))
        assert torch.equal(got, ref.gate(balanced, keys, gate, ct0, ct1)), gate
        carry_differs |= not torch.equal(got, ref.gate(p, keys, gate, ct0, ct1))
    assert carry_differs  # so diff_words tells the two conventions apart
