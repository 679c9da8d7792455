"""The port's examples (``repro_torch.train_lm``, ``serve_batch``,
``stream_stages``) held against the JAX package's ``examples/`` on the CPU:
the streaming demo prints the same results; the two model examples hand
their drivers the reference examples' command lines (and the device); each
runs end to end at a few steps."""

import importlib.util
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from repro_torch import serve_batch, stream_stages, train_lm
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMED = re.compile(r"in +[0-9.]+ ms")


def _results(cmd) -> list:
    """The lines a run of ``cmd`` prints, its times left out."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, *cmd], env=env, cwd=str(ROOT),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return [TIMED.sub("in <t> ms", line)
            for line in proc.stdout.strip().splitlines()]


def test_stream_stages_prints_the_reference_results():
    want = _results(["examples/stream_stages.py", "--items", "48"])
    got = _results(["-m", "repro_torch.stream_stages", "--items", "48"])
    assert got == want and len(got) == 3, (got, want)
    assert "pipeline/inline   48 items in <t> ms (inline=True)" in got


def _reference_example(name, monkeypatch, driver, argv):
    """``examples/<name>.py``'s ``main`` run with ``argv`` on the command
    line and its driver's ``main`` (``driver``: module, bound before the
    example is loaded) replaced by one that records its argv."""
    seen = []
    monkeypatch.setattr(driver, "main", lambda a: seen.append(a) or 0.0)
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    mod.main()
    return seen


def _port_argv(driver, monkeypatch, main, argv):
    seen = []
    monkeypatch.setattr(driver, "main", lambda a: seen.append(a) or 0.0)
    main(argv)
    return seen


@pytest.mark.parametrize("argv", [[], ["--steps", "7"], ["--full"],
                                  ["--full", "--steps", "9", "--resume"]])
def test_train_lm_hands_the_driver_the_reference_argv(monkeypatch, tmp_path,
                                                      argv):
    from repro.launch import train as jtrain

    argv = argv + ["--ckpt", str(tmp_path / "ck")]
    want = _reference_example("train_lm", monkeypatch, jtrain, argv)
    got = _port_argv(ttrain, monkeypatch, train_lm.main, argv)
    assert got == [want[0] + ["--device", "cuda"]], (got, want)
    got = _port_argv(ttrain, monkeypatch, train_lm.main,
                     argv + ["--device", "cpu"])
    assert got == [want[0] + ["--device", "cpu"]]


def test_train_lm_default_checkpoint_directory(monkeypatch):
    # the reference's /tmp/relic_train_ckpt, under the temporary directory
    # the environment gives
    monkeypatch.setenv("TMPDIR", "/tmp")
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    seen = _port_argv(ttrain, monkeypatch, train_lm.main, [])
    ck = seen[0][seen[0].index("--ckpt") + 1]
    assert ck == "/tmp/relic_train_ckpt"


@pytest.mark.parametrize("argv", [[], ["--arch", "rwkv6_1p6b", "--batch", "2",
                                       "--gen", "5"]])
def test_serve_batch_hands_the_driver_the_reference_argv(monkeypatch, argv):
    from repro.launch import serve as jserve

    want = _reference_example("serve_batch", monkeypatch, jserve, argv)
    got = _port_argv(tserve, monkeypatch, serve_batch.main, argv)
    assert got == [want[0] + ["--device", "cuda"]], (got, want)


def test_examples_run_end_to_end_on_the_cpu(tmp_path, capsys):
    loss = train_lm.main(["--steps", "3", "--ckpt", str(tmp_path / "ck"),
                          "--device", "cpu"])
    assert 0 < loss < 10
    assert (tmp_path / "ck").exists()
    toks = serve_batch.main(["--batch", "2", "--gen", "3", "--device", "cpu"])
    assert toks.shape == (2, 3) and toks.device == torch.device("cpu")
    stream_stages.main(["--items", "16"])
    out = capsys.readouterr().out
    assert "final loss:" in out and "farm/workers3     16 items" in out
