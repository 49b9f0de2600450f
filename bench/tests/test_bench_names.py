"""BENCHMARK.json keeps to the benchmark's contract: its keys, names,
units and strings, and every cell's files and metric readers exist."""
import json
import re

import pytest

from benchkit.spec import BENCH_DIR, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"proj|head_size|expansion|experts_per_tok")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

with open(ROOT / "BENCHMARK.json") as f:
    BENCH = json.load(f)
CELLS = {w["name"]: w for w in BENCH["workloads"]}
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(c) for c in cmd)
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    # a full check of 24 cells fits its 43,200 s
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def test_names_and_units():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert _line(w["why"]) and w["chips"] in (1, 4)


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert c["file"].split("/")[0] in BENCH["paths"]
        assert c["file"] not in files
        files.add(c["file"])
        with open(ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg and not WIDTH.search(key)


def test_end_to_end():
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_per_layer():
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in E2E
        for w in m.get("workloads", CELLS):
            assert w in CELLS
            assert w in E2E[m["moves"]].get("workloads", CELLS)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_files_and_metrics(cell):
    w = CELLS[cell]
    assert (BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file()
    assert (BENCH_DIR / "limits" / f"{cell}.json").is_file()
    e2e = [m for m in BENCH["end_to_end"] if cell in m.get("workloads",
                                                           [cell])]
    layer = [m for m in BENCH["per_layer"] if cell in m.get("workloads",
                                                            [cell])]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert layer
    for m in e2e + layer:
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file(), m


def test_four_chip_cells_few():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_file_names():
    for p in BENCH_DIR.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel
