"""The benchmark measures the port alone: a whole run loads no module
whose top-level name is jax, jaxlib, flax or repro (names compared whole,
since the port's own name begins with repro) and opens no file under
``benchmarks/``; the command exits without a result where there is no
card, no such cell, or no program beside the benchmark."""

import json
import os
import shutil
import subprocess
import sys

from portbench.harness import guard
from portbench.harness.spec import PKG, ROOT

RUN = str(PKG / "run.py")

WHOLE_RUN = r'''
import json, os, sys, tempfile
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0]))
                 if ev == "open" and isinstance(args[0], (str, bytes, os.PathLike)) else None)
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1]]
from pathlib import Path
from portbench.tests.smoke import run_cell, smoke_root
from portbench.harness import guard
import portbench.calibrate
root = smoke_root(Path(tempfile.mkdtemp()))
for cell in ("phi3_mini_3p8b.score_2k", "zamba2_1p2b.train_2k"):
    r = run_cell(root, cell, seconds=0.05, trace=cell.endswith("score_2k"))
    assert r["correct"], r["checks"]
print(json.dumps({"loaded": guard.loaded(),
                  "modules": sorted({m.split(".")[0] for m in sys.modules}),
                  "opened": [os.path.abspath(p) for p in opened]}))
'''


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("CUDA_VISIBLE_DEVICES", None)
    return env


def test_names_are_compared_whole():
    assert guard.loaded(["repro_torch", "repro_torch.models", "jaxtyping",
                         "reprox"]) == []
    assert guard.loaded(["repro.core", "jax.numpy", "flax", "jaxlib.xla",
                         "repro_torch"]) == ["flax", "jax", "jaxlib", "repro"]


def test_a_whole_run_loads_no_jax_and_reads_no_benchmarks_file():
    out = subprocess.run([sys.executable, "-c", WHOLE_RUN, str(ROOT)],
                         capture_output=True, text=True, timeout=600, env=_env())
    assert out.returncode == 0, out.stderr[-3000:]
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen["loaded"] == []
    assert not set(seen["modules"]) & guard.FORBIDDEN
    assert "repro_torch" in seen["modules"]
    banned = str(ROOT / "benchmarks") + os.sep
    assert not [p for p in seen["opened"] if p.startswith(banned)]


def _run(cwd, *args):
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={**_env(), "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    out = _run(ROOT, "--workload", "phi3_mini_3p8b.score_2k", "--seed",
               str(2**31 + 5), "--seconds", "1", "--trace", "0")
    assert out.returncode == 3 and out.stdout.strip() == ""
    assert "cuda" in out.stderr.lower()


def test_no_such_cell_no_result():
    out = _run(ROOT, "--workload", "nope.none", "--seed", "1", "--seconds", "1")
    assert out.returncode == 2 and out.stdout.strip() == ""


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(tmp_path, "--workload", "phi3_mini_3p8b.score_2k", "--seed", "7",
               "--seconds", "1")
    assert out.returncode != 0 and out.stdout.strip() == ""
