"""BENCHMARK.json keeps to its format and limits, and every name in it finds its files."""

from __future__ import annotations

import re

import pytest

from benchmark.benchlib import spec
from benchmark.reference import tfhe_ref as ref

BENCH = spec.benchmark_json()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
CELLS = [w["name"] for w in BENCH["workloads"]]


def _one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_the_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(_one_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128


def test_a_full_check_of_24_cells_fits_its_time():
    seconds = 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert seconds <= 43200


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_their_keys_and_allowed_names(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for entry in BENCH[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(entry) <= KEYS[section] | extra, entry["name"]
        assert NAME.match(entry["name"]), entry["name"]
        for key in ("why", "layer", "source"):
            if key in entry:
                assert _one_line(entry[key]), (entry["name"], key)
        if "unit" in entry:
            assert UNIT.match(entry["unit"]), entry["name"]
            assert entry["better"] in ("lower", "higher")
        for cell in entry.get("workloads", []):
            assert cell in CELLS


def test_metrics_sources_bounds_and_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files_and_reports_enough(cell):
    loaded = spec.load_cell(cell)
    assert loaded.chips in (1, 4)
    assert spec.client_class(loaded.traffic["client"])
    for m in loaded.end_to_end + loaded.per_layer:
        assert callable(spec.metric_reader(m["name"]))
        # a metric a cell reports moves an end-to-end metric that cell reports
        if "moves" in m:
            assert m["moves"] in {e["name"] for e in loaded.end_to_end}
    names = {m["name"] for m in loaded.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert loaded.per_layer
    assert {"impl", "control_impl", "check_requests", "limits"} <= set(loaded.workload)


def test_configs_are_their_own_files_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        body = spec.read_json(spec.ROOT / c["file"])
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    assert len({c["source"] for c in BENCH["configs"]}) == len(BENCH["configs"])


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"] if w["chips"] == 4])
def test_a_four_chip_cell_has_its_workload_file_and_a_client_that_takes_a_mesh(cell):
    assert (spec.BENCH_DIR / "workloads" / f"{cell}.json").is_file()
    client = spec.load_cell(cell).traffic["client"]
    assert (spec.BENCH_DIR / "clients" / f"{client}.py").is_file()
    assert getattr(spec.client_class(client), "accepts_mesh", False) is True


def test_files_under_paths_are_named_from_name_characters():
    for root in BENCH["paths"]:
        for path in (spec.ROOT / root).rglob("*"):
            if "__pycache__" in path.parts or path.is_dir():
                continue
            rel = path.relative_to(spec.ROOT).as_posix()
            assert PATH.match(rel), rel


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_a_base_that_does_not_divide_32_states_balanced_digits(config):
    body = spec.read_json(spec.BENCH_DIR / "configs" / f"{config}.json")
    digits = body.get("pbs_digits", "carry")
    assert digits in ref.DIGITS
    if 32 % body["pbs_log_base"]:  # the carry chain of decomposer.rs runs over 32 / log_base
        assert digits == "balanced", config
