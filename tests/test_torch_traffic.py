"""The port's collective-traffic model and recorder (``tfhe_tpu_torch/
parallel/traffic.py``) against the JAX package's ``tfhe_tpu/parallel/
traffic.py``, and the recorder's payloads on a gloo world of 2 CPU ranks.

The recorder stands in for JAX's HLO audit: every collective of the sharded
and pipelined gates goes through it, and in every mode its payloads equal
``expected_collectives`` at the rank's local batch.  The wraparound case
all-reduces int32-carried u32 deltas near +-2^31: the sum must be the one
mod 2^32, as JAX's psum gives.
"""

import inspect
import math

import numpy as np
import pytest

import tfhe_tpu.parallel.traffic as jtraffic
import tfhe_tpu_torch as ttfhe
from tfhe_tpu.params import get_params
from tfhe_tpu_torch.ops.torus import to_numpy_u32
from tfhe_tpu_torch.parallel import traffic
from tfhe_tpu_torch.parallel._testing import World

MODES = ("dp", "tp", "coeffs", "ntt", "pp")
PARAMS = ("test_insecure", "default_128")
#: u32 deltas near +-2^31 each of two ranks all-reduces (int32 bit patterns)
WRAP = [[2**31 - 1, -2**31, 2**31 - 1, -1, 0x12345678, -5],
        [1, -2**31, 2**31 - 1, -2**31, 0x7EDCBA98, 2**31 - 3]]
#: name -> (kind, mesh shape, impl, microbatches, model mode); 4 ciphertexts
WORLD_CASES = {
    "dp": ("sharded", (2, 1), "conv", 0, "dp"),
    "dp_fusedp": ("sharded", (2, 1), "fusedp", 0, "dp"),
    "dp_coeffs": ("sharded", (2, 1), "coeffs", 0, "dp"),
    "tp": ("sharded", (1, 2), "matmul", 0, "tp"),
    "tp_pallas": ("sharded", (1, 2), "pallas", 0, "tp"),
    "coeffs": ("sharded", (1, 2), "coeffs", 0, "coeffs"),
    "ntt": ("sharded", (1, 2), "ntt", 0, "ntt"),
    "pp": ("pipeline", (1, 2), "matmul", 3, "pp"),
}
B = 4


@pytest.mark.parametrize("name", PARAMS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("batch_local", [1, 2, 64])
def test_expected_collectives_equal_jax(name, mode, batch_local):
    p, tp = get_params(name), ttfhe.get_params(name)
    m = 3 if mode == "pp" else 0
    assert (traffic.expected_collectives(tp, mode, batch_local, m)
            == jtraffic.expected_collectives(p, mode, batch_local, m))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d", [1, 2, 3, 4, 8, 1024])
def test_wire_bytes_equal_jax(mode, d):
    p, tp = get_params("default_128"), ttfhe.get_params("default_128")
    assert (traffic.wire_bytes_per_sample_step(tp, mode, d)
            == jtraffic.wire_bytes_per_sample_step(p, mode, d))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("link_gbps", [25.0, 450.0])
def test_predict_efficiency_equals_jax(mode, d, link_gbps):
    p, tp = get_params("default_128"), ttfhe.get_params("default_128")
    kw = dict(link_gbps=link_gbps, us_per_sample_step=0.1234, m_microbatches=16)
    assert (traffic.predict_efficiency(tp, mode, d, **kw)
            == jtraffic.predict_efficiency(p, mode, d, **kw))


def test_section_9_1_wire_bytes():
    """docs/ARCHITECTURE.md section 9.1 at default_128: TP moves
    2(D-1)/D (k+1) N 4 bytes per sample-step (6,144 at D=2, up to 12,288),
    coeffs half of that (3,072 at D=2, up to 6,144), the NTT bins'
    raw planes 110,592 at D=2 (up to ~221 KB), the pipeline's hop
    (k+1) N 4 (D-1)/722 (~17 B at D=3); DP nothing."""
    tp = ttfhe.get_params("default_128")
    k1n4 = (tp.glwe_dimension + 1) * tp.degree * 4
    assert k1n4 == 6144
    assert traffic.wire_bytes_per_sample_step(tp, "tp", 2) == 6144.0
    assert abs(traffic.wire_bytes_per_sample_step(tp, "tp", 1 << 20) - 12288) < 0.1
    assert traffic.wire_bytes_per_sample_step(tp, "coeffs", 2) == 3072.0
    assert abs(traffic.wire_bytes_per_sample_step(tp, "coeffs", 1 << 20) - 6144) < 0.1
    assert traffic.wire_bytes_per_sample_step(tp, "ntt", 2) == 110592.0
    assert abs(traffic.wire_bytes_per_sample_step(tp, "ntt", 1 << 20) - 221184) < 1
    assert abs(traffic.wire_bytes_per_sample_step(tp, "pp", 3) - 17.02) < 0.01
    assert traffic.wire_bytes_per_sample_step(tp, "dp", 8) == 0.0


def test_link_rate_has_no_default():
    """No TPU link rate is built in: the caller names the link."""
    sig = inspect.signature(traffic.predict_efficiency)
    assert sig.parameters["link_gbps"].default is inspect.Parameter.empty


def test_recorder_counts_each_distinct_payload_once():
    """Like the HLO audit's while-loop body, a payload repeated by every
    step is one record; the calls are counted beside it."""
    import torch

    rec = traffic.CollectiveRecorder()
    delta = torch.zeros((2, 3, 8), dtype=torch.int32)
    for _ in range(5):
        rec._record("all-reduce", delta)
    rec._record("all-reduce", torch.zeros((2, 5), dtype=torch.int32))
    rec._record("all-gather", delta)
    rec._record("all-reduce", torch.zeros((6, 8), dtype=torch.int32))  # 192 bytes again
    assert rec.payloads() == {"all-reduce": {192, 40}, "all-gather": {192}}
    assert rec.collectives[traffic.Collective("all-reduce", "int32", (2, 3, 8), 192)] == 5
    assert rec.calls() == {"all-reduce": {192: 6, 40: 1}, "all-gather": {192: 1}}
    rec.reset()
    assert rec.payloads() == {} and rec.calls() == {}


@pytest.mark.parametrize("name", PARAMS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("batch_local", [1, 64])
def test_expected_calls_hold_the_model_payloads(name, mode, batch_local):
    """``expected_calls`` has ``expected_collectives``' sizes, n calls per
    scan step's payload plus one for the key switch, and M+S-1 hops plus one
    all-reduce for the pipeline."""
    p = ttfhe.get_params(name)
    m, stages = (3, 2) if mode == "pp" else (0, 1)
    calls = traffic.expected_calls(p, mode, batch_local, m, stages)
    assert ({k: set(v) for k, v in calls.items()}
            == traffic.expected_collectives(p, mode, batch_local, m))
    total = {k: sum(v.values()) for k, v in calls.items()}
    n = p.lwe_dimension
    assert total == {"dp": {}, "tp": {"all-reduce": n + 1}, "ntt": {"all-reduce": n + 1},
                     "coeffs": {"all-gather": n, "all-reduce": 1},
                     "pp": {"collective-permute": m + stages - 1, "all-reduce": 1}}[mode]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """A gloo world of 2 CPU ranks running every mode on 4 ciphertexts (and
    queues of them), plus the wraparound sum; the port's one-device gates."""
    p = ttfhe.get_params("test_insecure")
    ck, sk = ttfhe.keygen(p, 7, device="cpu")
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2, size=(2, 3, B))
    q0 = np.stack([to_numpy_u32(ttfhe.encrypt(ck, bits[0, i], 20 + i)) for i in range(3)])
    q1 = np.stack([to_numpy_u32(ttfhe.encrypt(ck, bits[1, i], 30 + i)) for i in range(3)])
    arrays = dict(lwe_sk=to_numpy_u32(ck.lwe_sk), glwe_sk=to_numpy_u32(ck.glwe_sk),
                  bk_u32=to_numpy_u32(sk.bk_u32), ksk_u32=to_numpy_u32(sk.ksk_u32),
                  ct0=q0[0], ct1=q1[0], q0_pp=q0, q1_pp=q1)
    cases = [dict(kind=kind, name=name, shape=list(shape), impl=impl)
             for name, (kind, shape, impl, _, _) in WORLD_CASES.items()]
    cases.append(dict(kind="wraparound", name="wrap", values=WRAP))
    world = World(dict(world=2, backend="gloo", device="cpu", params="test_insecure",
                       cases=cases), tmp_path_factory.mktemp("world2"), arrays)
    one = to_numpy_u32(ttfhe.gates.nand(sk, q0.reshape(-1, q0.shape[-1]),
                                        q1.reshape(-1, q1.shape[-1]), impl="conv"))
    return world.wait(240), one.reshape(q0.shape)


@pytest.mark.parametrize("name", list(WORLD_CASES))
def test_recorder_payloads_equal_the_model(world2, name):
    results, one = world2
    kind, shape, _, m, mode = WORLD_CASES[name]
    p, local = ttfhe.get_params("test_insecure"), B // math.prod(shape[:-1])
    want = traffic.expected_collectives(p, mode, batch_local=local, m_microbatches=m)
    want_calls = traffic.expected_calls(p, mode, local, m,
                                        n_stages=shape[-1] if kind == "pipeline" else 1)
    for rank in results["ranks"]:
        assert {k: set(v) for k, v in rank[name]["payloads"].items()} == want, name
        calls = {k: {int(b): c for b, c in v.items()} for k, v in rank[name]["calls"].items()}
        assert calls == want_calls, name
    out = results["outputs"][name]
    assert np.array_equal(out, one if kind == "pipeline" else one[0]), name


def test_all_reduce_of_u32_deltas_wraps_mod_2_32(world2):
    results, _ = world2
    want = (np.array(WRAP[0], dtype=np.int64) + np.array(WRAP[1], dtype=np.int64)) % (1 << 32)
    want = want.astype(np.uint32).view(np.int32).tolist()
    assert want[:3] == [-2**31, 0, -2]  # (2^31-1)+1, (-2^31)*2, (2^31-1)*2
    for rank in results["ranks"]:
        assert rank["wrap"]["sum"] == want


def test_bench_scaling_runs_every_mode_on_cpu_ranks():
    """``python -m tfhe_tpu_torch.bench_scaling`` on gloo CPU ranks at worlds
    1 and 2 (nano): every mode's output equals the one-device gate, and its
    recorded bytes equal the model at the rank's local batch."""
    import json
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-m", "tfhe_tpu_torch.bench_scaling", "--device", "cpu", "--params",
         "nano", "--batch-per-rank", "1", "--iters", "1", "--world", "2",
         "--link-gbps", "450"], capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["card"] == "cpu" and line["backend"] == "gloo"
    rows = {(r["mode"], r["world"]): r for r in line["results"]}
    assert set(rows) == {(m, w) for m in ("dp", "tp", "host", "pp") for w in (1, 2)}
    p = ttfhe.get_params("nano")
    for (mode, world), r in rows.items():
        assert r["gate_errors"] == 0 and r["equal_to_one_device"]
        model_mode = {"tp": "tp", "pp": "pp", "dp": "dp"}.get(mode, "tp" if world > 1 else "dp")
        want = traffic.expected_collectives(p, model_mode, r["batch_local"], 4)
        assert {k: set(v) for k, v in r["collective_bytes"].items()} == want, (mode, world)
        want_calls = traffic.expected_calls(p, model_mode, r["batch_local"], 4,
                                            n_stages=r["mesh"].get("stage", 1))
        calls = {k: {int(b): c for b, c in v.items()} for k, v in r["collective_calls"].items()}
        assert calls == want_calls, (mode, world)
        assert 0 < r["predicted_efficiency"] <= 1
