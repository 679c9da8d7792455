"""What the card tests of the hand-written kernels share: the ``card``
fixture, a kernel's output held against its plain version, and the device
operations of one call, read from the profiler's trace. Imports no JAX."""

import json
import os
import subprocess
import sys
import tempfile

import pytest
import torch

REL_TOL = 1e-2   # ||kernel - plain|| / ||plain||: a dropped kv tile fails it
DT = {torch.float32: "f32", torch.bfloat16: "bf16"}   # in case names


@pytest.fixture
def card():
    """The CUDA card, for the tests marked ``card``; they skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card: JAX_PLATFORMS=cpu "
                    "PYTHONPATH=src python -m pytest -m card tests portbench")
    return torch.device("cuda")


def hold(got, want, rtol, atol):
    """``got`` finite, within ``rtol`` / ``atol`` of ``want`` elementwise and
    within REL_TOL of it in relative norm."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all(), "non-finite output"
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    rel = ((got - want).norm() / want.norm()).item()
    assert rel < REL_TOL, f"relative error {rel} >= {REL_TOL}"


def one_kernel(module: str, key, name: str) -> None:
    """``trace_one_kernel`` of ``module.one_kernel_call(key)`` in a fresh
    interpreter: on the H100 a process's later profiler traces came back
    empty, trace after trace, while its first was whole every time."""
    tests = os.path.dirname(os.path.abspath(__file__))
    path = [tests, os.path.join(os.path.dirname(tests), "src"),
            os.environ.get("PYTHONPATH", "")]
    code = (f"import card_holds, {module} as m; card_holds.trace_one_kernel("
            f"m.one_kernel_call({key!r}), {name!r})")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=dict(
                             os.environ, PYTHONPATH=os.pathsep.join(path)))
    assert out.returncode == 0, (out.stdout + out.stderr)[-3000:]


def trace_one_kernel(fn, name: str, calls: int = 20, attempts: int = 3):
    """Each call of ``fn`` runs one device operation, the kernel ``name`` (no
    copy, memset or second kernel), in torch.profiler's trace of ``calls``
    calls; a trace with fewer operations is taken again."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="card_trace_")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        names = [e["name"] for e in events if "dur" in e and e.get("cat") in
                 ("kernel", "gpu_memcpy", "gpu_memset")]
        assert all(name in n for n in names), names
        assert len(names) <= calls, f"{len(names)} operations in {calls} calls"
        if len(names) == calls:
            return
    raise AssertionError(f"no whole trace of {calls} calls in {attempts}: the "
                         f"profiler delivered {len(names)} device operations")
