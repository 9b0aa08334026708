"""The port's sharded and pipelined gates (``tfhe_tpu_torch/parallel``)
against the JAX package's, bit for bit, on the CPU.

The JAX side runs in this process on the 8 virtual devices of
tests/conftest.py, with the inputs of tests/test_parallel.py's fixtures
(the key of ``jax.random.key(99)``, the bits of ``default_rng(3)``), its
``pallas`` in interpret mode.  The port's side runs in gloo worlds of 8
ranks (and 4 for the (1, 4) pipeline), one process per rank, started once
for the module by ``tfhe_tpu_torch.parallel._testing.World``: the ranks
import neither JAX nor this conftest.  Every output equals JAX's sharded
gate and the port's one-device gate (``np.array_equal``, tolerance 0).
"""

import math

import jax
import numpy as np
import pytest

import tfhe_tpu as jtfhe
import tfhe_tpu_torch as ttfhe
from tfhe_tpu.models.keys import with_ntt_key as j_with_ntt_key
from tfhe_tpu.parallel import mesh as jmesh
from tfhe_tpu.parallel.pipeline import make_pipelined_gate as j_pipelined
from tfhe_tpu.parallel.sharded import make_sharded_gate as j_sharded
from tfhe_tpu.params import get_params
from tfhe_tpu_torch.ops.torus import to_numpy_u32
from tfhe_tpu_torch.parallel._testing import World
from tfhe_tpu_torch.parallel.traffic import expected_calls, expected_collectives

TEST = get_params("test_insecure")
TTEST = ttfhe.get_params("test_insecure")
#: name -> (mesh shape, impl): (batch, model), or (host, batch, model)
SHARDED = {
    "conv_8x1": ((8, 1), "conv"),
    "conv_4x2": ((4, 2), "conv"),
    "matmul_4x2": ((4, 2), "matmul"),
    "pallas_4x2": ((4, 2), "pallas"),
    "coeffs_model2": ((4, 2), "coeffs"),
    "coeffs_model4": ((2, 4), "coeffs"),
    "ntt_bins_4x2": ((4, 2), "ntt"),
    "host_2x2x2": ((2, 2, 2), "conv"),
}
#: name -> ((batch, stage), microbatches, impl, world)
PIPELINES = {
    "pp_2x4_m3": ((2, 4), 3, "conv", 8),
    "pp_4x2_m2": ((4, 2), 2, "conv", 8),
    "pp_1x4_m5": ((1, 4), 5, "conv", 4),
    "pp_4x2_pallas": ((4, 2), 2, "pallas", 8),
    "pp_4x2_ntt": ((4, 2), 1, "ntt", 8),
}
#: name -> (mesh shape, impl, params changes, use_model_axis, the port's
#: exception, JAX's exception: None where it accepts, "-" where not compared)
GUARDS = {
    "model8_rows": ((1, 8), "conv", {}, None, "ValueError", "AssertionError"),  # 18 % 8
    "model4_rows": ((2, 4), "conv", {}, None, "ValueError", "AssertionError"),  # 18 % 4
    "coeffs_n512_model8": ((1, 8), "coeffs", {"log_degree": 9}, None, None, None),
    "coeffs_n2_model8": ((1, 8), "coeffs", {"log_degree": 1}, None, "ValueError",
                         "AssertionError"),  # N=2 < 8
    "mesh_3x2_of_8": ((3, 2), "conv", {}, None, "ValueError", "AssertionError"),
    # JAX's scan runs an unknown impl as 'matmul' (sharded.py:170-182)
    "unknown_impl": ((8, 1), "convv", {}, None, "ValueError", "-"),
    # a whole-scan impl runs under batch DP, and has no model-sharded form
    "fusedp_model2": ((4, 2), "fusedp", {}, None, "ValueError", "-"),
    # the policy reads the card's memory; a CPU mesh has none (JAX: 16 GiB)
    "policy_on_cpu": ((4, 2), "conv", {}, "policy", "ValueError", "-"),
}
#: (hbm_bytes, budget_frac) at which plan_key_placement is compared
PLACEMENTS = ((16 << 30, 0.25), (128 << 20, 0.25))
WAIT_S = 300


@pytest.fixture(scope="module")
def inputs():
    """tests/test_parallel.py's key and ciphertexts, and a microbatch queue
    per pipeline case (its bits rolled, as there)."""
    ck, sk = jtfhe.keygen(TEST, jax.random.key(99))
    rng = np.random.default_rng(3)
    lhs = rng.integers(0, 2, size=8).astype(np.uint32)
    rhs = rng.integers(0, 2, size=8).astype(np.uint32)
    arrays = dict(lwe_sk=np.asarray(ck.lwe_sk), glwe_sk=np.asarray(ck.glwe_sk),
                  bk_u32=np.asarray(sk.bk_u32), ksk_u32=np.asarray(sk.ksk_u32),
                  ct0=np.asarray(jtfhe.encrypt(ck, rhs, key=50)),
                  ct1=np.asarray(jtfhe.encrypt(ck, lhs, key=51)))
    for name, (_, m, _, _) in PIPELINES.items():
        arrays[f"q0_{name}"] = np.stack([np.asarray(jtfhe.encrypt(ck, np.roll(rhs, i),
                                                                  key=200 + i))
                                         for i in range(m)])
        arrays[f"q1_{name}"] = np.stack([np.asarray(jtfhe.encrypt(ck, np.roll(lhs, i),
                                                                  key=100 + i))
                                         for i in range(m)])
    return ck, sk, lhs, rhs, arrays


@pytest.fixture(scope="module")
def worlds(inputs, tmp_path_factory):
    """The port's worlds, started at once (they run while the JAX side
    computes); ``worlds()`` waits for them."""
    arrays = inputs[4]
    cases8 = [dict(kind="sharded", name=name, shape=list(shape), impl=impl)
              for name, (shape, impl) in SHARDED.items()]
    cases8 += [dict(kind="pipeline", name=name, shape=list(shape), impl=impl)
               for name, (shape, _, impl, world) in PIPELINES.items() if world == 8]
    cases8 += [dict(kind="refuse", name=name, shape=list(shape), impl=impl, replace=replace,
                    use_model_axis=use_model_axis)
               for name, (shape, impl, replace, use_model_axis, _, _) in GUARDS.items()]
    cases8 += [dict(kind="placement", name=f"placement_{i}", shape=[2, 2, 2],
                    params="default_128", hbm_bytes=hbm, budget_frac=frac)
               for i, (hbm, frac) in enumerate(PLACEMENTS)]
    cases4 = [dict(kind="pipeline", name=name, shape=list(shape), impl=impl)
              for name, (shape, _, impl, world) in PIPELINES.items() if world == 4]
    started = {
        world: World(dict(world=world, backend="gloo", device="cpu", params="test_insecure",
                          cases=cases), tmp_path_factory.mktemp(f"world{world}"), arrays)
        for world, cases in ((8, cases8), (4, cases4))}
    done = {}

    def results():
        if not done:
            done.update({w: started[w].wait(WAIT_S) for w in started})
        return done

    yield results
    results()  # never leave a rank running


@pytest.fixture(scope="module")
def jax_outs(inputs, worlds):
    """JAX's sharded and pipelined gates on the same inputs."""
    _, sk, _, _, arrays = inputs
    sk_ntt = j_with_ntt_key(sk)
    outs = {}
    for name, (shape, impl) in SHARDED.items():
        mesh = jmesh.make_host_mesh(*shape) if len(shape) == 3 else jmesh.make_mesh(*shape)
        gate = j_sharded(mesh, TEST, "nand", impl=impl, interpret=impl == "pallas")
        outs[name] = np.asarray(gate(arrays["ct0"], arrays["ct1"],
                                     sk_ntt if impl == "ntt" else sk))
    for name, ((b, s), _, impl, _) in PIPELINES.items():
        mesh = jmesh.make_pipeline_mesh(batch=b, stage=s, devices=jax.devices()[: b * s])
        gate = j_pipelined(mesh, TEST, "nand", impl=impl, interpret=impl == "pallas")
        outs[name] = np.asarray(gate(arrays[f"q0_{name}"], arrays[f"q1_{name}"],
                                     sk_ntt if impl == "ntt" else sk))
    return outs


@pytest.fixture(scope="module")
def one_device(inputs):
    """The port's one-device 'conv' gate on the same key and inputs: the
    batch and every queue's microbatches in one call."""
    _, _, _, _, arrays = inputs
    _, tsk = ttfhe.keys_from_numpy(TTEST, arrays["lwe_sk"], arrays["glwe_sk"],
                                   arrays["bk_u32"], arrays["ksk_u32"], device="cpu")
    names = ["batch"] + list(PIPELINES)
    ct0 = [arrays["ct0"]] + [arrays[f"q0_{name}"] for name in PIPELINES]
    ct1 = [arrays["ct1"]] + [arrays[f"q1_{name}"] for name in PIPELINES]
    shapes = [a.shape[:-1] for a in ct0]
    flat = [np.concatenate([a.reshape(-1, a.shape[-1]) for a in cts]) for cts in (ct0, ct1)]
    out = to_numpy_u32(ttfhe.gates.nand(tsk, *flat, impl="conv"))
    splits = np.cumsum([math.prod(s) for s in shapes])[:-1]
    return {name: part.reshape(shape + (-1,))
            for name, part, shape in zip(names, np.split(out, splits), shapes)}


def world_of(name):
    return PIPELINES[name][3] if name in PIPELINES else 8


@pytest.mark.parametrize("name", list(SHARDED))
def test_sharded_gate_equals_jax_and_one_device(inputs, worlds, jax_outs, one_device, name):
    _, _, lhs, rhs, _ = inputs
    got = worlds()[8]["outputs"][name]
    assert np.array_equal(got, jax_outs[name]), name
    assert np.array_equal(got, one_device["batch"]), name
    assert np.array_equal(np.asarray(jtfhe.decrypt(inputs[0], got)), 1 - (lhs & rhs))


@pytest.mark.parametrize("name", list(PIPELINES))
def test_pipelined_gate_equals_jax_and_one_device(worlds, jax_outs, one_device, name):
    got = worlds()[world_of(name)]["outputs"][name]
    assert got.shape == jax_outs[name].shape
    assert np.array_equal(got, jax_outs[name]), name
    assert np.array_equal(got, one_device[name]), name


def mode_of(shape, impl, pipeline):
    if pipeline:
        return "pp"
    if shape[-1] == 1:
        return "dp"
    return {"coeffs": "coeffs", "ntt": "ntt"}.get(impl, "tp")


@pytest.mark.parametrize("name", list(SHARDED) + list(PIPELINES))
def test_every_rank_records_the_model_payloads(worlds, name):
    """Each rank's recorded collectives equal ``expected_collectives`` at its
    local batch (the recorder stands in for JAX's HLO audit), and their
    calls ``expected_calls``: one per scan step and one for the key switch,
    or one hop per pipeline tick and one final all-reduce."""
    pipeline = name in PIPELINES
    shape, impl = (PIPELINES[name][0], PIPELINES[name][2]) if pipeline else SHARDED[name]
    m = PIPELINES[name][1] if pipeline else 0
    mode, local = mode_of(shape, impl, pipeline), 8 // math.prod(shape[:-1])
    want = expected_collectives(TTEST, mode, batch_local=local, m_microbatches=m)
    want_calls = expected_calls(TTEST, mode, local, m, n_stages=shape[-1] if pipeline else 1)
    for rank in worlds()[world_of(name)]["ranks"]:
        got = {kind: set(v) for kind, v in rank[name]["payloads"].items()}
        assert got == want, (name, got, want)
        calls = {kind: {int(b): n for b, n in v.items()}
                 for kind, v in rank[name]["calls"].items()}
        assert calls == want_calls, (name, calls, want_calls)


@pytest.mark.parametrize("name", list(GUARDS))
def test_mesh_model_size_and_impl_guards(worlds, name):
    """The port refuses, as ValueError, what JAX refuses with an
    AssertionError: a mesh that is not the world's size, a model size that
    does not divide the GGSW rows R=18 or (for 'coeffs') the degree N; and
    an impl it does not know, which JAX would run as 'matmul'."""
    shape, impl, replace, use_model_axis, port_raises, jax_raises = GUARDS[name]
    for rank in worlds()[8]["ranks"]:
        assert rank[name]["raised"] == port_raises, rank[name]
    if jax_raises == "-":
        return
    params = TEST.replace(**replace)
    if jax_raises:
        with pytest.raises(AssertionError):
            j_sharded(jmesh.make_mesh(*shape), params, "nand", impl=impl)
    else:
        j_sharded(jmesh.make_mesh(*shape), params, "nand", impl=impl)


@pytest.mark.parametrize("index", range(len(PLACEMENTS)))
def test_key_placement_agrees_with_jax(worlds, index):
    hbm, frac = PLACEMENTS[index]
    want = jmesh.plan_key_placement(get_params("default_128"),
                                    jmesh.make_host_mesh(host=2, batch=2, model=2),
                                    hbm_bytes=hbm, budget_frac=frac)
    for rank in worlds()[8]["ranks"]:
        assert rank[f"placement_{index}"]["placement"] == [
            want.shard_bk_rows, want.bk_bytes, want.per_device_key_bytes]
