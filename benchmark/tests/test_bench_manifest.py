"""BENCHMARK.json against the benchmark's contract: names, units, keys,
files found by name, which cells report which metrics, the time a full
check takes."""

import json
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
MAN = harness.manifest()


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(MAN["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               and not p.endswith("_torch") for p in MAN["paths"])
    assert len(MAN["command"]) <= 32 and all(_line(w) for w in MAN["command"])


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_names_and_lines(section):
    entries = MAN[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)


def test_configs_files_and_reduced():
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(MAN["paths"][0] + "/")
        conf = json.loads((harness.ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not k.endswith(("_dim", "_rank",
                                                     "channels"))
                   for k in c["reduced"])


def test_cells_are_found_by_name():
    pairs = set()
    for w in MAN["workloads"]:
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell, conf, traffic = harness.load_cell(w["name"])
        assert (harness.HERE / "drivers" / f"{traffic['driver']}.py").is_file()
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_every_cell_reports_setup_another_e2e_and_a_layer():
    e2e = MAN["end_to_end"]
    assert "setup_s" in {m["name"] for m in e2e}
    for m in e2e:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in MAN["workloads"]:
        mine = [m["name"] for m in e2e if _reports(m, w["name"])]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(_reports(m, w["name"]) for m in MAN["per_layer"])


def test_each_layer_metric_moves_an_e2e_metric_its_cells_report():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m["workloads"]:
            assert _reports(e2e[m["moves"]], cell), (m["name"], cell)
        assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"


def test_one_layer_name_a_layer():
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["name"].split(".")[0].split("_roofline")[0],
                          set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_a_full_check_fits_its_time():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    total = (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200
    assert total <= 43200
