"""The quickstart path of the port (``repro_torch.quickstart``, the JAX
package's ``examples/quickstart.py``) held as a whole: it runs as a user
runs it, and from one train state a train step followed by eight greedy
decode steps gives the same tokens in both packages (f32)."""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch.steps import make_serve_step as jmake_serve_step
from repro.launch.steps import make_train_state as jmake_train_state
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import build_model as jbuild_model
from repro.optim import OptConfig as JOptConfig
from repro_torch import quickstart
from repro_torch.configs import get_config
from repro_torch.kernels import relic_matmul as rm
from repro_torch.models import build_model
from repro_torch.models.convert import train_state_from_numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]
F32 = dict(param_dtype="float32", compute_dtype="float32")


def test_quickstart_module_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.quickstart", "--smoke", "--device",
         "cpu"], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "quickstart OK", proc.stdout
    assert "parallel_for squares: [0, 1, 4, 9, 16, 25, 36, 49]" in proc.stdout


def test_quickstart_main_returns_its_sections():
    before = (rm.launches, rm.gated_launches)
    out = quickstart.main(["--smoke", "--device", "cpu"])
    assert out["squares"] == [i * i for i in range(8)] and out["total"] == 140
    assert np.isfinite(float(out["metrics"]["loss"]))
    assert out["tokens"].shape == (quickstart.BATCH, 1)
    assert out["matmul_err"] == 0.0   # on the CPU ops.matmul is the oracle
    assert (rm.launches, rm.gated_launches) == before


def test_quickstart_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        quickstart.main(["--smoke", "--device", "cuda"])


def _jax_train_and_decode(jmodel, jstate, rng):
    """Sections 2 and 3 of examples/quickstart.py, as written there."""
    cfg = jmodel.cfg
    b, s = quickstart.BATCH, quickstart.SEQ
    batch = {
        "tokens": jnp.asarray(rng.integers(0, cfg.vocab_size, (b, s)), jnp.int32),
        "labels": jnp.asarray(rng.integers(0, cfg.vocab_size, (b, s)), jnp.int32),
        "mask": jnp.ones((b, s), jnp.float32),
    }
    train_step = jax.jit(jmake_train_step(jmodel, JOptConfig(total_steps=100)))
    state, metrics = train_step(jstate, batch)
    serve_step = jax.jit(jmake_serve_step(jmodel))
    cache = jmodel.init_cache(b, quickstart.CACHE_LEN)
    tok = jnp.asarray(rng.integers(0, cfg.vocab_size, (b, 1)), jnp.int32)
    for t in range(quickstart.DECODE_STEPS):
        tok, _, cache = serve_step(state["params"], cache, tok, jnp.int32(t))
    return metrics, np.asarray(tok)


@pytest.mark.parametrize("arch", ["relic_tiny", "rwkv6_1p6b", "zamba2_1p2b"])
def test_train_step_then_decode_matches_jax(arch):
    jcfg = jget_config(arch, smoke=True).replace(**F32)
    tcfg = get_config(arch, smoke=True).replace(**F32)
    jmodel = jbuild_model(jcfg)
    jstate = jmake_train_state(jmodel, jax.random.PRNGKey(0))
    tstate = train_state_from_numpy(
        tcfg, jax.tree.map(lambda a: np.asarray(a, np.float32), jstate))
    jm, jtok = _jax_train_and_decode(jmodel, jstate, np.random.default_rng(0))
    _, tm, ttok = quickstart.train_and_decode(
        build_model(tcfg, "cpu"), tstate, np.random.default_rng(0), "cpu")
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-4,
                                   err_msg=key)
    np.testing.assert_array_equal(ttok.numpy(), jtok)
