"""The import guard, and a measurement path without a card."""
import io
import os
import subprocess
import sys
import types

import torch
from conftest import BENCH, SMALL

import run
from statbench import guard

ROOT = os.path.dirname(BENCH)


def test_guard_compares_whole_top_level_names():
    mods = {"statmc_tpu_torch": 1, "statmc_tpu_torch.driver": 1,
            "jaxtyping": 1, "jax_helpers": 1}
    assert guard.forbidden_loaded(mods) == []
    mods.update({"statmc_tpu.driver": 1, "jax.numpy": 1, "flax": 1})
    assert guard.forbidden_loaded(mods) == ["flax", "jax.numpy",
                                            "statmc_tpu.driver"]


def test_harness_reference_and_loops_load_no_jax():
    """Every module of the harness (the loops that drive the traffic, the
    reference, the metric readers, the scene and frame generators) and the
    parts of the port they call, in a fresh interpreter."""
    code = (
        "import glob, os, sys\n"
        f"sys.path[:0] = [{BENCH!r}, {ROOT!r}]\n"
        "import run\n"
        "from statbench import (capture, cells, common, guard, judge,"
        " pathref, peaks, readers, reference, trace)\n"
        "import statmc_tpu_torch.driver, statmc_tpu_torch.denoise.filter\n"
        f"for p in glob.glob(os.path.join({BENCH!r}, 'metrics', '*.py')):\n"
        "    cells.metric_reader(os.path.basename(p)[:-3])\n"
        f"for p in glob.glob(os.path.join({BENCH!r}, 'loops', '*.py')):\n"
        "    cells.loop_class({'traffic': {'loop':"
        " os.path.basename(p)[:-3]}})\n"
        "for s in ('staircase', 'terrain', 'frames'):\n"
        "    cells.scene_module(s)\n"
        "print(guard.forbidden_loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _args(cell="staircase-denoise-frames", trace=0):
    return run.parse_args(["--workload", cell, "--seed", "2147483999",
                           "--seconds", "0.2", "--trace", str(trace)])


def test_run_refuses_when_jax_was_loaded(monkeypatch):
    monkeypatch.setitem(sys.modules, "statmc_tpu", types.ModuleType("x"))
    out, err = io.StringIO(), io.StringIO()
    rc = run.run(_args(), device=torch.device("cpu"), overrides=SMALL,
                 out=out, err=err)
    assert rc == 3 and out.getvalue() == ""
    assert "statmc_tpu" in err.getvalue()


def test_no_card_no_result(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, err = io.StringIO(), io.StringIO()
    assert run.run(_args(), out=out, err=err) == 2
    assert out.getvalue() == "" and "no CUDA" in err.getvalue()


def test_too_few_cards_no_result(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    out, err = io.StringIO(), io.StringIO()
    assert run.run(_args(), out=out, err=err) == 2
    assert out.getvalue() == ""


def test_no_result_without_the_program(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's files
    exits non-zero and prints no result."""
    import shutil

    shutil.copytree(BENCH, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload",
         "staircase-denoise-frames", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env={k: v for k, v in os.environ.items()
                          if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout.strip() == ""
