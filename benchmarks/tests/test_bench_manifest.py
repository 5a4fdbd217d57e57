"""BENCHMARK.json against the benchmark's contract, and the harness
finding a cell's parts by name."""
import json
import os
import re
import shutil

import pytest
from conftest import BENCH

from statbench import cells, judge

ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_sizes(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len(manifest["command"]) <= 32
    for w in manifest["command"]:
        assert LINE.match(w)
    assert 1 <= manifest["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10


def test_names_and_units(manifest):
    seen = set()
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert LINE.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        names = [x["name"] for x in manifest[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    assert len(names) == len(set(names)) and not seen


def test_metrics_contract(manifest):
    cellnames = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in manifest["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cellnames)) <= cellnames
    layers = {}
    for m in manifest["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.match(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", cellnames):
            assert cell in set(e2e[m["moves"]].get("workloads", cellnames))
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    for cell in cellnames:
        reported = [m for m in manifest["end_to_end"]
                    if cell in m.get("workloads", cellnames)]
        assert len(reported) >= 2
        assert any(cell in m.get("workloads", cellnames)
                   for m in manifest["per_layer"])


def test_budget(manifest):
    rs = manifest["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_parts_found_by_name(manifest):
    for w in manifest["workloads"]:
        c = cells.find(w["name"])
        assert os.path.exists(os.path.join(BENCH, "loops",
                                           c["traffic"]["loop"] + ".py"))
        loop = cells.loop_class(c)
        for method in ("warm_up", "window", "traced", "release", "check"):
            assert callable(getattr(loop, method))
        assert os.path.exists(os.path.join(BENCH, "scenes",
                                           c["config"]["scene"] + ".py"))
        assert c["config"]["integrator_name"]
        assert c["limits"]
        for m in c["per_layer"]:
            assert callable(cells.metric_reader(m["name"]))
    for c in manifest["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert any(w["config"] == c["name"] for w in manifest["workloads"])


def _pbrt_params(text):
    out = {}
    for m in re.finditer(r'"(\w+)\s+(\w+)"\s*\[([^\]]*)\]', text):
        vals = re.findall(r'"[^"]*"|[-0-9.e]+', m.group(3))
        out[m.group(2)] = [v.strip('"') for v in vals]
    return out


def test_configs_follow_upstream(manifest):
    """Each configuration's settings are its upstream file's, but for the
    keys that `reduced` lists."""
    for c in manifest["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        up = _pbrt_params(open(os.path.join(BENCH, "configs",
                                            cfg["upstream"])).read())
        mine = {k.split()[-1]: [str(v) for v in vals]
                for k, vals in {**cfg["integrator"], **cfg["sampler"]}.items()
                if k != "name"}
        changed = {k for k in up if [float(x) if re.match(r"^[-0-9.e]+$", x)
                                     else x for x in up[k]]
                   != [float(x) if re.match(r"^[-0-9.e]+$", x) else x
                       for x in mine.get(k, [])]}
        assert changed == set(c["reduced"]) == set(cfg["reduced"])


_NEW_LOOP = '''"""A loop added as a file."""


class Loop:
    def __init__(self, cell, seed, device, overrides=None):
        self.cell, self.seed = cell, seed

    def warm_up(self):
        pass

    def window(self, seconds):
        return {"samples_per_s": 1.0}

    def traced(self, seconds):
        return {}

    def release(self):
        pass

    def check(self, control=False, notes=None):
        return [("answers_wrong", 0.0, float(self.cell["limits"]["x"]))]
'''


def test_new_cell_is_picked_up(tmp_path):
    """A cell, a configuration (with another integrator), a traffic mix, a
    loop of its own and a metric added as files and entries, in a copy,
    with no harness file edited."""
    bench = tmp_path / "benchmarks"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__"))
    m = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cfg = json.load(open(bench / "configs" / "staircase.json"))
    cfg["film"]["integer xresolution"] = [640]
    cfg["integrator_name"] = "bdpt"
    json.dump(cfg, open(bench / "configs" / "staircase_small.json", "w"))
    mix = json.load(open(bench / "traffic" / "render_loop.json"))
    mix["check_pixels"] = 64
    json.dump(mix, open(bench / "traffic" / "render_loop_light.json", "w"))
    json.dump({"moment_gap": 1}, open(bench / "limits" / "new-cell.json",
                                      "w"))
    (bench / "metrics" / "new_metric.render.py").write_text(
        "def read(ctx):\n    return 1.0\n")
    m["configs"].append(dict(m["configs"][0], name="staircase_small",
                             file="benchmarks/configs/staircase_small.json"))
    m["workloads"].append({"name": "new-cell", "config": "staircase_small",
                           "traffic": "render_loop_light", "chips": 1,
                           "why": "a test"})
    m["per_layer"].append({"name": "new_metric.render", "unit": "%",
                           "better": "lower", "source": "device_trace",
                           "layer": "device", "moves": "setup_s",
                           "workloads": ["new-cell"]})
    json.dump(m, open(tmp_path / "BENCHMARK.json", "w"))
    c = cells.find("new-cell", root=str(tmp_path), bench_dir=str(bench))
    assert c["config"]["film"]["integer xresolution"] == [640]
    assert c["traffic"]["check_pixels"] == 64
    assert [x["name"] for x in c["per_layer"]] == ["new_metric.render"]
    assert cells.metric_reader("new_metric.render",
                               bench_dir=str(bench))({}) == 1.0
    assert cells.scene(c["config"])[0].startswith('Integrator "bdpt" ')

    # A mix that names a loop of its own, in a file of its own.
    (bench / "loops" / "answer_stream.py").write_text(_NEW_LOOP)
    json.dump({"loop": "answer_stream"},
              open(bench / "traffic" / "answers.json", "w"))
    json.dump({"x": 0}, open(bench / "limits" / "loop-cell.json", "w"))
    m["workloads"].append({"name": "loop-cell", "config": "staircase_small",
                           "traffic": "answers", "chips": 1, "why": "a test"})
    json.dump(m, open(tmp_path / "BENCHMARK.json", "w"))
    c = cells.find("loop-cell", root=str(tmp_path), bench_dir=str(bench))
    lp = cells.loop_class(c, bench_dir=str(bench))(c, 1, None)
    lp.warm_up()
    assert lp.window(1.0) == {"samples_per_s": 1.0}
    assert judge.correct(lp.check())
