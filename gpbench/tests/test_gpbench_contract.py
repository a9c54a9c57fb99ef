"""``BENCHMARK.json`` keeps to the form the benchmark's check reads."""

import json
import os
import re

from .conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def load():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_names_and_units():
    b = load()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(b["command"]) <= 32 and all(map(line, b["command"]))
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in b["paths"])
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["source"]) and line(c["why"])
        assert c["file"].startswith(b["paths"][0] + "/")
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and NAME.match(w["traffic"])
        assert w["chips"] == 1 and line(w["why"])
        names.append(w["name"])
    for kind, keys in (("end_to_end", {"name", "unit", "better", "bound",
                                       "source"}),
                       ("per_layer", {"name", "unit", "better", "source",
                                      "layer", "moves"})):
        for m in b[kind]:
            assert set(m) - {"workloads"} == keys, m["name"]
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
            names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert len(json.dumps(b)) <= 64 * 1024


def test_metrics_and_cells():
    b = load()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in b["per_layer"]:
        assert m["moves"] in e2e and line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m.get("workloads", []):
            assert w in cells and w in e2e[m["moves"]].get("workloads",
                                                           cells)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in cells:                # setup_s, another end-to-end, a layer
        assert sum(w in m.get("workloads", cells)
                   for m in e2e.values()) >= 2
        assert any(w in m.get("workloads", cells) for m in b["per_layer"])


def test_run_length_fits_the_check():
    s = load()["run_seconds"]
    assert 1 <= s <= 51 and s == int(s)
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200
