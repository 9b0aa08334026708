"""The harness driven on the CPU at nano: a sound run is correct, and its
control and each fault planted in the timed path come out not correct.
Also: the command refuses to run without a card, and nothing it loads is JAX
or the JAX package."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark.benchlib import guard, spec
from benchmark.tests.cells import run_small, small_cell
from tfhe_tpu_torch.models import bootstrap, keyswitch

CELLS = [w["name"] for w in spec.benchmark_json()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(cell, trace):
    result = run_small(small_cell(cell), trace=trace)
    assert result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    assert {c["value"] for c in result["checks"].values()} == {0}
    declared = spec.load_cell(cell)
    names = {m["name"] for m in (declared.per_layer if trace else declared.end_to_end)}
    assert set(result["metrics"]) <= names
    if not trace:  # the end-to-end metrics read the host clock, so the CPU gives them all
        assert set(result["metrics"]) == names
    else:
        assert result["device"]["window_s"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    result = run_small(small_cell(cell), control=True)
    assert result["correct"] is False
    assert result["checks"]["diff_words"]["value"] > 0


def _skip_last_step(monkeypatch):
    """A CMUX step that returns its state unchanged: the last mask
    coefficient read as 0, so the last step rotates by X^0."""
    orig = bootstrap.blind_rotate

    def rotate(params, approx_ct, *args, **kwargs):
        approx_ct = approx_ct.clone()
        approx_ct[..., params.lwe_dimension - 1] = 0
        return orig(params, approx_ct, *args, **kwargs)

    monkeypatch.setattr(bootstrap, "blind_rotate", rotate)


def _half_batch(monkeypatch):
    """Half of each batch left out, the computed half standing in for it."""
    orig = bootstrap.pbs

    def pbs(params, ct, *args, **kwargs):
        keep = (ct.shape[0] + 1) // 2
        out = orig(params, ct[:keep], *args, **kwargs)
        return torch.cat([out, out[:ct.shape[0] - keep]])

    monkeypatch.setattr(bootstrap, "pbs", pbs)


def _altered_word(monkeypatch):
    """One word of each PBS's first answer altered where it is produced."""
    orig = keyswitch.key_switch

    def key_switch(*args, **kwargs):
        out = orig(*args, **kwargs)
        out[..., 0, 0] += 1
        return out

    monkeypatch.setattr(keyswitch, "key_switch", key_switch)


def _flipped_answer(monkeypatch):
    """Each PBS's first answer moved by Delta: it decrypts to the other bit."""
    orig = keyswitch.key_switch

    def key_switch(*args, **kwargs):
        out = orig(*args, **kwargs)
        out[..., 0, -1] += 1 << 29
        return out

    monkeypatch.setattr(keyswitch, "key_switch", key_switch)


FAULTS = {"skip_last_step": (_skip_last_step, "diff_words"),
          "half_batch": (_half_batch, "diff_words"),
          "altered_word": (_altered_word, "diff_words"),
          "flipped_answer": (_flipped_answer, "wrong_bits")}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_in_the_timed_path_is_not_correct(cell, fault, monkeypatch):
    plant, caught_by = FAULTS[fault]
    plant(monkeypatch)
    result = run_small(small_cell(cell))
    assert result["correct"] is False
    assert result["checks"][caught_by]["value"] > 0


def test_the_forbidden_names_are_compared_whole():
    assert guard.forbidden_modules(["tfhe_tpu_torch", "tfhe_tpu_torch.models.keys",
                                    "torch", "jaxtyping", "flaxen"]) == []
    assert guard.forbidden_modules(["tfhe_tpu.models", "jax.numpy", "jaxlib", "flax.linen",
                                    "tfhe_tpu_torch"]) == ["flax", "jax", "jaxlib", "tfhe_tpu"]


#: run.py's main on the CPU: the card check answered yes, the cell run at nano
#: (``cells.small_cell``); with ``plant``, a metric reader imports a module
#: named ``jax`` once the window has closed
_MAIN_ON_CPU = """
import runpy, sys, types
import torch
sys.path.insert(0, '.')
from benchmark.benchlib import runner, spec
from benchmark.tests import cells
is_available, device_count = torch.cuda.is_available, torch.cuda.device_count
torch.cuda.is_available, torch.cuda.device_count = (lambda: True), (lambda: 1)
run_cell, metric_reader = runner.run_cell, spec.metric_reader

def small_run(cell, seed, seconds, trace, device, t_start, control=False, marks=None,
              group=None):
    torch.cuda.is_available, torch.cuda.device_count = is_available, device_count
    return run_cell(cells.small_cell(cell.name), seed, seconds, trace, torch.device('cpu'),
                    t_start, control=control, marks=marks, group=group)

def planted_reader(name, root=spec.ROOT):
    read = metric_reader(name, root)

    def planted(run):
        sys.modules['jax'] = types.ModuleType('jax')
        return read(run)
    return planted

runner.run_cell = small_run
if {plant}:
    spec.metric_reader = planted_reader
sys.argv = ['run.py', '--workload', {cell!r}, '--seed', '5', '--seconds', '0.3',
            '--trace', '0']
runpy.run_path('benchmark/run.py', run_name='__main__')
"""


@pytest.mark.parametrize("plant", [False, True])
def test_a_module_loaded_after_the_window_stops_the_result(plant):
    proc = _python(_MAIN_ON_CPU.format(plant=plant, cell=CELLS[0]))
    if not plant:  # the same run untouched prints its result
        assert proc.returncode == 0, proc.stderr
        assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is True
        return
    assert proc.returncode == 3
    assert proc.stdout == ""
    assert "before the result: forbidden modules loaded: jax" in proc.stderr


def _python(code: str, cwd=spec.ROOT) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=300)


def test_a_loaded_cell_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "from benchmark.benchlib import runner, spec, guard;"
            "[spec.client_class(spec.load_cell(w['name']).traffic['client'])"
            " for w in spec.benchmark_json()['workloads']];"
            "[spec.metric_reader(m['name']) for k in ('end_to_end', 'per_layer')"
            " for m in spec.benchmark_json()[k]];"
            "print(guard.forbidden_modules())")
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_program():
    proc = _python("import sys; sys.path.insert(0, '.');"
                   "import benchmark.reference.tfhe_ref;"
                   "print(sorted({m.split('.')[0] for m in sys.modules} & "
                   "{'tfhe_tpu_torch', 'tfhe_tpu', 'jax'}))")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")


def test_the_command_refuses_to_run_without_a_card():
    _no_card()
    cmd = json.loads((spec.ROOT / "BENCHMARK.json").read_text())["command"]
    proc = subprocess.run(cmd + ["--workload", CELLS[0], "--seed", str(2**31 + 3),
                                 "--seconds", "1", "--trace", "0"],
                          cwd=spec.ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "needs 1 CUDA card" in proc.stderr


def test_the_command_fails_with_the_benchmark_alone(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cmd = json.loads((spec.ROOT / "BENCHMARK.json").read_text())["command"]
    proc = subprocess.run(cmd + ["--workload", CELLS[0], "--seed", "5", "--seconds", "1",
                                 "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
