"""The port's entry points for measurement on the CPU: ``python -m
tfhe_tpu_torch.bench`` (bench.py's JSON line), ``python -m
tfhe_tpu_torch.bench_adder`` (wrong sums and wrong carries counted apart),
the profiling helpers, and the rule that none of the new modules loads JAX."""

import contextlib
import io
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tfhe_tpu_torch import bench, bench_adder
from tfhe_tpu_torch.models import boolean as mbool
from tfhe_tpu_torch.models import circuits as mcirc
from tfhe_tpu_torch.ops.cuda import latency_kernel as latk
from tfhe_tpu_torch.utils.profiling import Timer

ROOT = Path(__file__).resolve().parents[1]
#: the breakdown keys of bench.py:184-212 and of its stage, latency and check
#: parts
BENCH_PY_KEYS = {
    "impl", "digit_convention", "approx_truncated_key", "batch", "keygen_s",
    "bk_mbytes", "gate_ms", "per_rotation_step_us", "int8_tops", "bk_bytes_per_step",
    "stages_ms", "non_rotation_pct", "latency_ms", "latency_synced_ms", "gate_errors",
    "noise_max_over_delta", "noise_mean_over_delta"}
PBS_SCOPES = ("pbs.mod_switch", "pbs.blind_rotate", "pbs.sample_extract", "pbs.key_switch")


def stdout_of(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


@pytest.fixture(scope="module")
def bench_run(tmp_path_factory):
    trace = tmp_path_factory.mktemp("trace")
    out = stdout_of(bench.main, ["--params", "nano", "--device", "cpu", "--batch", "4",
                                 "--iters", "1", "--latency", "--trace", str(trace)])
    return out, trace


def test_bench_prints_one_json_line(bench_run):
    out, _ = bench_run
    lines = out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == "gate bootstraps/sec/chip (default_128 NAND, batched PBS)"
    assert line["unit"] == "bootstraps/s" and line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / 1000, 3)
    b = line["breakdown"]
    assert BENCH_PY_KEYS <= set(b)
    assert {"device", "card", "power_limit", "sm_clock_mhz", "keyform_s",
            "first_call_s"} <= set(b)
    assert b["gate_errors"] == 0 and b["noise_max_over_delta"] < 0.5
    assert (b["impl"], b["batch"], b["device"], b["card"]) == ("conv", 4, "cpu", None)
    assert set(b["stages_ms"]) == {"linear+modswitch", "blind_rotate", "sample_extract",
                                   "key_switch"}
    assert set(b["latency_ms"]) == set(b["latency_synced_ms"]) == {"1", "4"}


def test_bench_trace_holds_the_pbs_scopes(bench_run):
    _, trace = bench_run
    files = list(trace.glob("*.json"))
    assert len(files) == 1
    text = files[0].read_text()
    for name in PBS_SCOPES:
        assert f'"{name}"' in text, name


def test_bench_auto_is_its_own():
    """The bench's 'auto' is 'fusedp' at B=1024 on the card and 'conv' at
    B=64 on the CPU; the library's 'auto' is untouched."""
    from tfhe_tpu_torch.models.bootstrap import resolve_impl

    assert bench.resolve_bench_impl("auto", True) == "fusedp"
    assert bench.resolve_bench_impl("auto", False) == "conv"
    assert bench.resolve_bench_impl("nttf", True) == "nttf"
    assert (bench.default_batch("fusedp", True), bench.default_batch("conv", False)) == (1024, 64)
    assert (bench.default_batch("fusedl", True), bench.default_batch("bmmpl", True)) == (8, 4)
    assert resolve_impl("auto", "cuda") == "pallas"


@pytest.mark.parametrize("error", [ValueError, RuntimeError])
def test_bench_latency_catches_only_refusals(monkeypatch, error):
    """``--latency`` records a batch the impl refuses before any launch
    (ValueError) and goes on; any other error propagates."""
    check = latk.check_batch

    def refuse_four(batch, variants):
        if batch == 4:
            raise error("refused at B=4")
        check(batch, variants)

    monkeypatch.setattr(latk, "check_batch", refuse_four)
    argv = ["--params", "nano", "--device", "cpu", "--impl", "fusedl", "--batch", "8",
            "--iters", "1", "--latency", "--no-stages"]
    if error is RuntimeError:
        with pytest.raises(RuntimeError, match="refused at B=4"):
            stdout_of(bench.main, argv)
        return
    b = json.loads(stdout_of(bench.main, argv))["breakdown"]
    assert b["latency_ms"]["4"] == "refused: ValueError"
    assert isinstance(b["latency_ms"]["1"], float) and isinstance(b["latency_ms"]["8"], float)
    assert "4" not in b["latency_synced_ms"] and b["gate_errors"] == 0


ADDER_ARGV = ["--params", "nano", "--device", "cpu", "--width", "4", "--batch", "2",
              "--iters", "1", "--impl", "fused"]


def test_bench_adder_counts_no_errors(tmp_path):
    out_file = tmp_path / "adder.json"
    line = json.loads(stdout_of(bench_adder.main, ADDER_ARGV + ["--out", str(out_file)]))
    assert line == json.loads(out_file.read_text())
    assert (line["wrong_sums"], line["wrong_carries"]) == (0, 0)
    assert line["bootstraps_per_add"] == 20 and line["add_ms"] > 0
    assert {"per_stage_noise", "max_noise_by_depth", "noise_flat_across_depth", "card",
            "keyform_s", "first_call_s"} <= set(line)
    assert all(v["failures"] == 0 for v in line["per_stage_noise"].values())


def test_bench_adder_counts_a_wrong_carry_apart(tmp_path, monkeypatch):
    """A carry-out flipped after the add counts under ``wrong_carries`` alone
    (the reference script adds carry errors into its sum errors)."""
    add = mcirc.ripple_carry_add

    def flipped_carry(sk, a, b, *args, **kwargs):
        s, cout = add(sk, a, b, *args, **kwargs)
        return s, mbool.not_(sk, cout)

    monkeypatch.setattr(mcirc, "ripple_carry_add", flipped_carry)
    line = json.loads(stdout_of(bench_adder.main,
                                ADDER_ARGV + ["--out", str(tmp_path / "adder.json")]))
    assert (line["wrong_sums"], line["wrong_carries"]) == (0, 2)


def test_timer_marks():
    timer = Timer()
    seconds = timer.mark("stage", torch.zeros(3))
    assert seconds >= 0 and timer.marks == [("stage", seconds)]
    assert "stage:" in str(timer)


def test_new_modules_load_no_jax():
    """The port's entry points and utilities load neither JAX nor the JAX
    package (the card's machine has no JAX)."""
    code = ("import sys\n"
            "import tfhe_tpu_torch.cli, tfhe_tpu_torch.bench, tfhe_tpu_torch.bench_adder\n"
            "import tfhe_tpu_torch.utils.serialization, tfhe_tpu_torch.utils.profiling\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tfhe_tpu')]\n"
            "print(bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, check=True)
    assert proc.stdout.strip() == "[]"
