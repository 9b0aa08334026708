"""A configuration and a client come in as new files and entries alone.

The benchmark is copied to a directory of its own, and only new files are
added there: a configuration on the default_128 lattice with balanced PBS
digits, a client module of its own (with its ``SMALL`` traffic), its traffic
mix and a cell on ``fusedb``, whose entries BENCHMARK.json gains.  The copy's
own, unedited helpers then run the cell at nano on the CPU: it is correct,
and its control, ``fusedb3``, is not."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

from benchmark.benchlib import spec

CONFIG, CELL = "d128_balanced", "d128b.gates.b8.fusedb"
CLIENT, TRAFFIC = "gate_batch_own", "gates.b8"

NEW_FILES = {
    f"configs/{CONFIG}.json": dict(
        spec.read_json(spec.BENCH_DIR / "configs" / "default_128.json"), name=CONFIG,
        source="https://example.org/a-second-source (a stand-in for a test)",
        pbs_digits="balanced"),
    f"workloads/{CELL}.json": {"impl": "fusedb", "control_impl": "fusedb3", "check_requests": 2,
                               "limits": {"wrong_bits": 0, "diff_words": 0}},
    f"traffic/{TRAFFIC}.json": {"client": CLIENT, "batch": 8, "pool": 2,
                                "gates": ["and", "or", "xor", "nand", "nor", "xnor", "andny",
                                          "andyn"]},
    f"clients/{CLIENT}.py": ('"""gate_batch under a name of its own."""\n\n'
                             "from benchmark.clients import gate_batch\n\n"
                             'SMALL = {"batch": 3, "pool": 2}\n\n\n'
                             "class Client(gate_batch.Client):\n"
                             "    pass\n"),
}

#: run in the copy: the cell through the copy's own helpers, sound and control
_RUN = f"""
import json, sys
sys.path.insert(0, '.')
from benchmark.tests.cells import run_small, small_cell
cell = small_cell({CELL!r})
out = {{"pbs_digits": cell.config["pbs_digits"], "batch": cell.traffic["batch"]}}
for control in (False, True):
    result = run_small(cell, control=control)
    out[str(control)] = [result["correct"], result["checks"]["diff_words"]["value"]]
print(json.dumps(out))
"""


def _digest(path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_a_new_configuration_and_client_run_as_new_files_alone(tmp_path):
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): _digest(p)
              for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    (tmp_path / "tfhe_tpu_torch").symlink_to(spec.ROOT / "tfhe_tpu_torch")
    for rel, body in NEW_FILES.items():
        path = tmp_path / "benchmark" / rel
        assert not path.exists(), rel
        path.write_text(body if isinstance(body, str) else json.dumps(body, indent=2))
    bench = spec.benchmark_json()
    config = NEW_FILES[f"configs/{CONFIG}.json"]
    bench["configs"].append({"name": CONFIG, "source": config["source"],
                             "file": f"benchmark/configs/{CONFIG}.json", "reduced": [],
                             "why": "the default_128 lattice with balanced PBS digits"})
    bench["workloads"].append({"name": CELL, "config": CONFIG, "traffic": TRAFFIC, "chips": 1,
                               "why": "8 gates a call on fusedb"})
    for metric in bench["end_to_end"]:  # the new cell reports the gates cells' rate
        if metric["name"] == "gate_bootstraps_per_s":
            metric["workloads"].append(CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    # nothing that was there changed
    assert before == {rel: _digest(tmp_path / rel) for rel in before}

    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run([sys.executable, "-c", _RUN], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["pbs_digits"] == "balanced" and out["batch"] == 3
    assert out["False"] == [True, 0]  # fusedb against the balanced reference
    correct, diff_words = out["True"]
    assert correct is False and diff_words > 0  # fusedb3, the control
