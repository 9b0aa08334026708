"""The port's span and counter recorder (``utils/profiling.py``) and the
spans and counters of the gate and circuit layers.

The CPU cases drive a ``nano`` ripple-carry add through the plain twins under
``torch.profiler.profile``; the ``cuda`` cases run ``default_128`` on the card
and skip without one.  The file imports neither JAX nor tfhe_tpu, so it also
runs on a machine without JAX:

    python -m pytest tests/test_torch_tracing.py -q -o addopts= --noconftest
"""

import time
import warnings
from collections import Counter

import numpy as np
import pytest
import torch

import tfhe_tpu_torch as tfhe
from tfhe_tpu_torch.models import boolean as mbool
from tfhe_tpu_torch.utils import profiling as prof

W, BATCH = 4, 2
STAGES = ["pbs.mod_switch", "pbs.blind_rotate", "pbs.sample_extract", "pbs.key_switch"]
CPU = [torch.profiler.ProfilerActivity.CPU]


def profiled(fn, activities=CPU):
    """``fn()`` under a profiler, the recorder cleared before it; returns
    the profile."""
    prof.reset()
    with torch.profiler.profile(activities=activities) as p:
        fn()
    return p


@pytest.fixture(scope="module")
def nano():
    params = tfhe.get_params("nano")
    ck, sk = tfhe.keygen(params, 5, device="cpu")
    a = tfhe.circuits.encrypt_uint(ck, [5, 9], W, 3)
    b = tfhe.circuits.encrypt_uint(ck, [7, 3], W, 4)
    return ck, sk, a, b


def expected_gates(w, batch):
    """(gate, batch) of each PBS of a log_p = 2 ripple-carry add, in order."""
    return ([("xor", w * batch), ("and", w * batch)] + [("and", batch), ("or", batch)] * w
            + [("xor", w * batch)])


def test_an_add_records_one_root_and_its_gates_with_their_stages(nano):
    ck, sk, a, b = nano
    out = []
    profiled(lambda: out.append(tfhe.circuits.ripple_carry_add(sk, a, b, impl="fused")))
    s, c = out[0]
    assert tfhe.circuits.decrypt_uint(ck, s).tolist() == [12, 12]
    assert tfhe.decrypt(ck, c).tolist() == [0, 0]
    spans = prof.spans()
    assert all(sp.end_ns is not None and sp.start_ns <= sp.end_ns for sp in spans)
    roots = [sp for sp in spans if sp.parent is None]
    assert [r.name for r in roots] == ["circuits.ripple_carry_add"]
    root = roots[0]
    assert root.request == root.id
    assert root.attrs == {"width": W, "batch": BATCH, "impl": "fused"}
    assert all(sp.request == root.id for sp in spans)
    gates = [sp for sp in spans if sp.parent == root.id]
    assert all(g.name == "pbs.gate" for g in gates)
    assert [g.attrs for g in gates] == [{"gate": name, "impl": "fused"}
                                        for name, _ in expected_gates(W, BATCH)]
    for g in gates:
        children = [sp for sp in spans if sp.parent == g.id]
        assert [sp.name for sp in children] == ["pbs.lincomb", "pbs.test_vector"] + STAGES
        assert all(g.start_ns <= sp.start_ns <= sp.end_ns <= g.end_ns for sp in children)
        assert not [sp for sp in spans if sp.parent in {ch.id for ch in children}]
    assert len(spans) == 1 + 7 * (2 * W + 3)


def test_the_counters_hold_the_calls_and_ciphertexts(nano):
    _, sk, a, b = nano
    profiled(lambda: tfhe.circuits.ripple_carry_add(sk, a, b, impl="fused"))
    counters = prof.counters()
    batches = [n for _, n in expected_gates(W, BATCH)]
    assert counters["pbs.calls"] == 2 * W + 3
    assert counters["pbs.ciphertexts"] == sum(batches) == 40
    assert "pbs.card_waits" not in counters  # a CPU key: nothing is copied to a card


def test_spans_share_the_profilers_clock(nano):
    _, sk, a, b = nano
    profiled(lambda: tfhe.circuits.ripple_carry_add(sk, a, b, impl="fused"))  # warm
    p = profiled(lambda: tfhe.circuits.ripple_carry_add(sk, a, b, impl="fused"))
    spans = prof.spans()
    events = {}
    for e in p.profiler.kineto_results.events():
        if e.is_user_annotation() and (e.name().startswith("pbs.")
                                       or e.name().startswith("circuits.")):
            events.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    by_name = {}
    for sp in spans:
        by_name.setdefault(sp.name, []).append((sp.start_ns, sp.end_ns))
    assert {k: len(v) for k, v in by_name.items()} == {k: len(v) for k, v in events.items()}
    worst = 0
    for name, recorded in by_name.items():
        for (s0, s1), (k0, k1) in zip(recorded, sorted(events[name])):
            worst = max(worst, abs(s0 - k0), abs(s1 - k1))
    assert worst <= 200_000, f"{worst} ns between a span and its profiler range"
    # not the host's monotonic clock, which starts near boot
    assert abs(spans[0].start_ns - time.time_ns()) < 600e9


def test_with_no_profiler_scope_is_the_shared_no_op(nano, monkeypatch):
    _, sk, a, b = nano
    profiled(lambda: mbool.nand(sk, a[0], b[0], impl="fused"))
    spans, counters = prof.spans(), prof.counters()
    assert counters["pbs.calls"] == 1 and len(spans) == 7
    entered = []
    real = torch.profiler.record_function

    def spy(*args, **kwargs):
        entered.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    assert prof.scope("pbs.anything", batch=3) is prof.NO_SCOPE
    assert prof.card_wait("pbs") is prof.NO_SCOPE
    mbool.nand(sk, a[0], b[0], impl="fused")
    tfhe.circuits.ripple_carry_add(sk, a, b, impl="fused")
    prof.count("pbs.calls", 5)
    assert entered == []
    assert prof.counters() == counters
    assert [(sp.id, sp.name) for sp in prof.spans()] == [(sp.id, sp.name) for sp in spans]


def test_each_profiled_window_reads_only_its_own(nano):
    """With no ``reset()`` between them, as in the benchmark: an untraced
    request between two profiled windows starts the store afresh."""
    _, sk, a, b = nano
    profiled(lambda: tfhe.circuits.ripple_carry_add(sk, a, b, impl="fused"))
    first = {sp.id for sp in prof.spans()}
    mbool.nand(sk, a[0], b[0], impl="fused")  # no profiler: the next record starts afresh
    with torch.profiler.profile(activities=CPU):
        mbool.nand(sk, a[0], b[0], impl="fused")
    assert prof.counters() == {"pbs.calls": 1, "pbs.ciphertexts": BATCH,
                               "pbs.test_vector_hits": 1}  # cached by the unprofiled gate
    assert len(prof.spans()) == 7 and not first & {sp.id for sp in prof.spans()}
    prof.reset()
    assert prof.spans() == [] and prof.counters() == {}


def test_the_store_is_capped_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(prof, "MAX_SPANS", 3)

    def nested():
        with prof.scope("test.root"):
            for i in range(4):
                with prof.scope("test.child", i=i):
                    with prof.scope("test.leaf"):
                        pass

    profiled(nested)
    spans = prof.spans()
    assert [sp.name for sp in spans] == ["test.root", "test.child", "test.leaf"]
    assert prof.counters()[prof.SPANS_DROPPED] == 6
    assert spans[2].parent == spans[1].id and spans[1].parent == spans[0].id


def test_a_card_wait_is_counted_and_charged_to_every_open_span():
    def waits():
        with prof.scope("test.outer"):
            with prof.scope("test.inner"):
                with prof.card_wait("test"):
                    time.sleep(0.02)
            with prof.card_wait("test"):
                time.sleep(0.01)

    profiled(waits)
    outer, inner = prof.spans()
    assert prof.counters() == {"test.card_waits": 2}
    assert inner.wait_s >= 0.02 and outer.wait_s >= inner.wait_s + 0.01
    assert outer.end_ns - outer.start_ns >= outer.wait_s * 1e9


def test_every_pbs_backed_gate_opens_a_gate_span(nano):
    ck, sk, a, b = nano
    ct = a[0]

    def gates():
        mbool.bootstrap_identity(sk, ct, impl="fused")
        mbool.apply_lut(sk, ct, [1, 0, 1, 0], impl="fused")
        mbool.mux(sk, ct, a[1], b[1], impl="fused")

    profiled(gates)
    spans = prof.spans()
    gates_ = [sp for sp in spans if sp.name == "pbs.gate"]
    assert [g.attrs["gate"] for g in gates_] == ["identity", "lut", "and", "andny", "or"]
    assert all(g.parent is None and g.request == g.id for g in gates_)
    names = Counter(sp.name for sp in spans)
    assert names["pbs.lincomb"] == 3 and names["pbs.test_vector"] == 5
    assert prof.counters()["pbs.ciphertexts"] == 5 * BATCH


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card_add():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: Kernel C has no CPU mode")
    params = tfhe.get_params("default_128")
    ck, sk = tfhe.keygen(params, 0)
    sk = tfhe.with_latency_key(sk)
    a = tfhe.circuits.encrypt_uint(ck, [200], 8, 3)
    b = tfhe.circuits.encrypt_uint(ck, [100], 8, 4)

    def add():
        return tfhe.circuits.ripple_carry_add(sk, a, b, impl="fusedl")

    s, c = add()  # builds or loads Kernel C
    assert tfhe.circuits.decrypt_uint(ck, s).tolist() == [44]
    assert tfhe.decrypt(ck, c).tolist() == [1]
    torch.cuda.synchronize()
    return add


@pytest.mark.cuda
def test_a_warm_add_makes_no_synchronising_call(card_add):
    """Once the fixture's add has put its test vectors on the card, an add
    neither waits on the card nor copies a test vector there."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            card_add()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message) for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    torch.cuda.synchronize()
    assert syncs == []
    profiled(card_add, CPU + [torch.profiler.ProfilerActivity.CUDA])
    counters = prof.counters()
    assert counters.get("pbs.card_waits", 0) == 0
    assert counters.get("pbs.test_vector_uploads", 0) == 0
    assert counters["pbs.test_vector_hits"] == counters["pbs.calls"] == 19
    assert counters["pbs.ciphertexts"] == 40
    gates = [sp for sp in prof.spans() if sp.name == "pbs.gate"]
    assert len(gates) == 19 and all(g.wait_s == 0 for g in gates)


@pytest.mark.cuda
def test_kernel_c_starts_after_its_gate_span_starts(card_add):
    p = profiled(card_add, CPU + [torch.profiler.ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    events = p.profiler.kineto_results.events()
    launches = {e.correlation_id(): e.start_ns() for e in events
                if str(e.device_type()).endswith("CPU") and e.name().startswith("cu")}
    kernels = sorted((e.start_ns(), launches.get(e.correlation_id())) for e in events
                     if not str(e.device_type()).endswith("CPU")
                     and "latency_kernel" in e.name())
    gates = sorted((sp for sp in prof.spans() if sp.name == "pbs.gate"),
                   key=lambda sp: sp.start_ns)
    assert len(kernels) == len(gates) == 19
    for (start, launched), g in zip(kernels, gates):
        assert start > g.start_ns
        assert launched is not None and g.start_ns <= launched <= g.end_ns
    assert np.all(np.diff([k[0] for k in kernels]) > 0)


@pytest.mark.cuda
def test_a_traced_nttf_gate_counts_kernel_ds_exchanges():
    """Kernel D makes one Dh and one Ch exchange a step, each of both CRT
    primes: a traced 'nttf' gate at default_128 counts 722 x 2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: Kernel D has no CPU mode")
    params = tfhe.get_params("default_128")
    ck, sk = tfhe.keygen(params, 0)
    sk = tfhe.with_key_form(sk, "nttf")
    a = tfhe.encrypt(ck, np.array([0, 0, 1, 1]), 1)
    b = tfhe.encrypt(ck, np.array([0, 1, 0, 1]), 2)
    assert tfhe.decrypt(ck, mbool.nand(sk, a, b, impl="nttf")).tolist() == [1, 1, 1, 0]
    out = []
    profiled(lambda: out.append(mbool.nand(sk, a, b, impl="nttf")),
             CPU + [torch.profiler.ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    assert tfhe.decrypt(ck, out[0]).tolist() == [1, 1, 1, 0]
    counters = prof.counters()
    assert counters["pbs.calls"] == 1
    assert counters["pbs.nttf_exchanges"] == params.lwe_dimension * 2 == 722 * 2
