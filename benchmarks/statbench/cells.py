"""Finding a cell's parts by name.

A cell of BENCHMARK.json names a configuration and a traffic mix.  Each is
a data file of its own: ``configs/<config>.json`` (the scene generator
under ``scenes/``, its arguments, the film and the upstream integrator
and sampler settings), ``traffic/<traffic>.json`` (the name of the loop
that drives the window, and its parameters) and ``limits/<cell>.json``
(the limit of every number that decides ``correct``).  A loop is
``loops/<loop>.py`` with one class, ``Loop``, which brings its own check;
a per-layer metric is ``metrics/<metric>.py`` with one function,
``read(ctx)``.  Adding a cell, a configuration, a mix, a loop or a
metric adds files; it edits none.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES_DIR = os.path.join(BENCH_DIR, "scenes")


def repo_root(bench_dir: str = BENCH_DIR) -> str:
    return os.path.dirname(bench_dir)


def manifest(root: str | None = None) -> dict:
    with open(os.path.join(root or repo_root(), "BENCHMARK.json")) as f:
        return json.load(f)


def _json(bench_dir: str, kind: str, name: str) -> dict:
    path = os.path.join(bench_dir, kind, name + ".json")
    with open(path) as f:
        return json.load(f)


def find(workload: str, root: str | None = None,
         bench_dir: str = BENCH_DIR) -> dict:
    """The cell named `workload`: its BENCHMARK.json entry, configuration,
    traffic mix and limits, and the end-to-end and per-layer metrics that
    it reports (each BENCHMARK.json entry whose `workloads` lists it, or
    that has no `workloads`)."""
    m = manifest(root)
    entries = [w for w in m["workloads"] if w["name"] == workload]
    if len(entries) != 1:
        raise KeyError(f"no cell {workload!r} in BENCHMARK.json")
    w = entries[0]

    def mine(metrics):
        return [x for x in metrics if workload in x.get("workloads",
                                                         [workload])]

    return {"entry": w, "config": _json(bench_dir, "configs", w["config"]),
            "traffic": _json(bench_dir, "traffic", w["traffic"]),
            "limits": _json(bench_dir, "limits", workload),
            "end_to_end": mine(m["end_to_end"]),
            "per_layer": mine(m["per_layer"]),
            "run_seconds": m["run_seconds"]}


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loop_class(cell: dict, bench_dir: str = BENCH_DIR):
    """Loop of loops/<loop>.py, the loop that the cell's mix names."""
    name = cell["traffic"]["loop"]
    path = os.path.join(bench_dir, "loops", name + ".py")
    return load_module(path, "bench_loop_" + name.replace(".", "_")
                       .replace("-", "_")).Loop


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """read(ctx) of metrics/<name>.py."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    return load_module(path, "bench_metric_" + name.replace(".", "_")
                       .replace("-", "_")).read


def _param_text(params: dict) -> str:
    def val(v):
        return '"' + v + '"' if isinstance(v, str) else repr(v)

    return " ".join(f'"{k}" [{" ".join(val(v) for v in vals)}]'
                    for k, vals in params.items())


def effective(config: dict, overrides: dict | None = None) -> dict:
    """The configuration with `overrides` ({"film": {...}, "integrator":
    {...}, "scene_args": {...}}) in place of its entries: the CPU tests'
    small frames and scenes, never a measured run."""
    out = dict(config)
    for block in ("film", "integrator", "scene_args"):
        out[block] = dict(config.get(block, {}),
                          **(overrides or {}).get(block, {}))
    return out


def scene_module(name: str):
    """scenes/<name>.py (the scene generators import one another)."""
    if SCENES_DIR not in sys.path:
        sys.path.insert(0, SCENES_DIR)
    return load_module(os.path.join(SCENES_DIR, name + ".py"),
                       "bench_scene_" + name)


def scene(config: dict):
    """(pbrt text, Geometry) of a configuration."""
    gen = scene_module(config["scene"])
    body, geo = gen.build(**config.get("scene_args", {}))
    film, integ = config["film"], config["integrator"]
    sampler = dict(config["sampler"])
    sname = sampler.pop("name")
    text = (f'Integrator "{config["integrator_name"]}" '
            f'{_param_text(integ)}\n'
            f'Sampler "{sname}" {_param_text(sampler)}\n'
            f'Film "image" {_param_text(film)} '
            f'"string filename" ["{config["scene"]}.pfm"]\n'
            + gen.CAMERA + "WorldBegin\n" + body + "WorldEnd\n")
    return text, geo


def setting(config: dict, key: str) -> list:
    """The values of one integrator, sampler or film setting, by its name
    (the part of the pbrt parameter after the type)."""
    for block in (config["integrator"], config["sampler"], config["film"]):
        for k, v in block.items():
            if k.split()[-1] == key:
                return list(v)
    raise KeyError(key)
