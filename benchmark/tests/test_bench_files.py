"""BENCHMARK.json against the benchmark contract: every name resolves to a
file, every name and unit is made of the allowed characters, and the
entries have just the keys the contract gives them."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(map(_line, BENCH["command"]))
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", list(KEYS))
def test_entries(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end",
                                              "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)


def test_names_resolve_to_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith(BENCH["paths"][0])
        cfg = json.loads(path.read_text())
        assert (path.parent / cfg["lut_folder"] / "header.txt").is_file()
        assert len(c["reduced"]) <= 16 and all(map(NAME.match, c["reduced"]))
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert w["config"] in configs
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        mix = ROOT / "benchmark/traffic" / f"{w['traffic']}.json"
        entry = json.loads(mix.read_text())["entry"]
        assert NAME.match(entry)
        assert (ROOT / "benchmark/entries" / f"{entry}.py").is_file()
        assert w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in BENCH["per_layer"]:
        assert (ROOT / "benchmark/metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells


def test_metrics_follow_the_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert {"mpix_s", "encode_p95_ms", "decode_p95_ms", "setup_s"} <= set(e2e)
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
            kernel = m["name"][:-len("_roofline")]
            assert (ROOT / "benchmark/roofline" / f"{kernel}.py").is_file()
            assert (ROOT / "benchmark/counters" / f"{kernel}.py").is_file()
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert layers["entropy.bpc_cuda"] >= {"k1_roofline", "k2_roofline"}


def test_a_full_check_fits_with_24_cells():
    """2 + 14 runs a cell, each run_seconds + 60, 2 x 90 s of compiling a
    cell and 1200 s spare, within 43200 s."""
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
