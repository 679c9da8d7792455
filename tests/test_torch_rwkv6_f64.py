"""RWKV-6's f32 gradients against a float64 truth.

At SMOKE size, batch 2 x 16, seed 0, the port's f32 gradient of an
embedding row lies about 2.4e-4 from the reference's jitted ``jax.grad``,
on a leaf whose largest gradient is 6.5. Whether that is summation order
or a fault is decided against a truth computed in float64 on the same
parameters and batch: copies of both packages in which every f32 island
(``jnp.float32``, ``.float()``, ``torch.float32``) is widened to float64,
the parameters still drawn in f32 and then widened, so that both runs see
the same values.

In float64 the two packages compute the same function: the port's
gradients meet ``jax.grad``'s to the last bits. In f32 the port's
gradients lie no further from the truth than the reference's own jitted
and eager ones do (at the embedding table, about 16x closer), so the
spread is the reference's f32 rounding, not a fault of the port.
"""

import os
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

SRC = Path(__file__).resolve().parent.parent / "src"
TIMEOUT_S = 300

GRADS = """
import sys
import numpy as np
x64 = sys.argv[2] == "float64"
import jax
if x64:
    jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import torch
from repro import configs as jconfigs
from repro.launch.steps import make_train_state as jmake_train_state
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.launch import steps as tsteps
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models.convert import named_to_numpy, params_from_numpy

dtn = sys.argv[2]
if x64:
    L._DTYPES["float64"] = torch.float64
    torch.set_default_dtype(torch.float64)
kw = dict(param_dtype=dtn, compute_dtype=dtn, remat="none")
jcfg = jconfigs.get_config("rwkv6_1p6b", smoke=True).replace(**kw)
tcfg = get_config("rwkv6_1p6b", smoke=True).replace(**kw)
rng = np.random.default_rng(0)
b, s = 2, 16
batch = {"tokens": rng.integers(0, tcfg.vocab_size, (b, s)),
         "labels": rng.integers(0, tcfg.vocab_size, (b, s)),
         "mask": (rng.random((b, s)) > 0.25).astype(np.float32)}
jmodel = jbuild_model(jcfg)
params = jmake_train_state(jmodel, jax.random.PRNGKey(0))["params"]
# the f32 run's values exactly (a constant such as -0.6 differs in f64)
params = jax.tree.map(lambda a: a.astype(jnp.float32).astype(a.dtype), params)
jb = {k: jnp.asarray(v) for k, v in batch.items()}


def loss(p, bb):
    return jmodel.loss(p, bb)[0]


jit = jax.jit(jax.grad(loss))(params, jb)
with jax.disable_jit():
    eager = jax.grad(loss)(params, jb)
tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, params))
_, tg = tsteps._grads(build_model(tcfg, "cpu"),
                      tparams, {k: torch.from_numpy(np.asarray(v))
                                for k, v in batch.items()})
port = named_to_numpy(tparams, tg)
out = {}
for (path, a), e, t in zip(jax.tree_util.tree_flatten_with_path(jit)[0],
                           jax.tree.leaves(eager), jax.tree.leaves(port)):
    key = jax.tree_util.keystr(path)
    for name, v in (("jit", a), ("eager", e), ("port", t)):
        out[f"{key}|{name}"] = np.asarray(v, np.float64)
np.savez(sys.argv[1], **out)
"""

# f32 islands widened to float64: the reference's models and kernels, and
# the port's models, train step and parameter conversion
F64_REWRITES = {
    "repro/models": [(r"jnp\.float32", "jnp.float64")],
    "repro/kernels": [(r"jnp\.float32", "jnp.float64")],
    "repro_torch/models": [(r"\.float\(\)", ".double()"),
                           (r"torch\.float32", "torch.float64"),
                           (r"np\.float32", "np.float64")],
    "repro_torch/launch/steps.py": [(r"\.float\(\)", ".double()"),
                                    (r"torch\.float32", "torch.float64")],
}
# ... but the parameters are still drawn in f32, as the f32 run draws them
F32_DRAW = ("repro/models/layers.py",
            "jax.random.normal(key, shape, jnp.float64)",
            "jax.random.normal(key, shape, jnp.float32)")


def _widened_copy(dst: Path) -> Path:
    src = dst / "src"
    for pkg in ("repro", "repro_torch"):
        shutil.copytree(SRC / pkg, src / pkg,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for where, subs in F64_REWRITES.items():
        path = src / where
        files = [path] if path.is_file() else sorted(path.glob("*.py"))
        for f in files:
            text = f.read_text()
            for pat, rep in subs:
                text = re.sub(pat, rep, text)
            f.write_text(text)
    rel, old, new = F32_DRAW
    f = src / rel
    assert old in f.read_text()
    f.write_text(f.read_text().replace(old, new))
    return src


@pytest.fixture(scope="module")
def grads(tmp_path_factory):
    """{dtype: {"leaf|jit|eager|port": gradient}} from the f32 packages and
    their float64 copies, run at once in two processes."""
    d = tmp_path_factory.mktemp("rwkv6_f64")
    roots = {"float32": SRC, "float64": _widened_copy(d)}
    procs = {}
    for dtn, root in roots.items():
        env = dict(os.environ, PYTHONPATH=str(root), JAX_PLATFORMS="cpu",
                   OMP_NUM_THREADS="1")
        procs[dtn] = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(GRADS),
             str(d / f"{dtn}.npz"), dtn], env=env, cwd=str(d),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for dtn, proc in procs.items():
        try:
            _, err = proc.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
            raise
        assert proc.returncode == 0, err[-4000:]
        with np.load(d / f"{dtn}.npz") as z:
            out[dtn] = {k: z[k] for k in z.files}
    return out


def _leaves(g):
    return sorted({k.rsplit("|", 1)[0] for k in g})


def test_float64_packages_compute_the_same_gradients(grads):
    g = grads["float64"]
    for leaf in _leaves(g):
        want = g[f"{leaf}|jit"]
        scale = np.abs(want).max()
        for name in ("eager", "port"):
            err = np.abs(g[f"{leaf}|{name}"] - want).max()
            assert err <= 1e-12 * scale, (leaf, name, err, scale)


def test_port_f32_gradients_no_further_from_the_truth(grads):
    truth, g = grads["float64"], grads["float32"]
    for leaf in _leaves(g):
        t = truth[f"{leaf}|jit"]
        err = {n: np.abs(g[f"{leaf}|{n}"] - t).max()
               for n in ("jit", "eager", "port")}
        assert err["port"] <= max(err["jit"], err["eager"]), (leaf, err)
    # the leaf that raised the question: an embedding row's gradient
    emb = "['embed']['table']"
    t = truth[f"{emb}|jit"]
    port = np.abs(g[f"{emb}|port"] - t).max()
    jit = np.abs(g[f"{emb}|jit"] - t).max()
    assert np.abs(g[f"{emb}|port"] - g[f"{emb}|jit"]).max() > 1e-4
    assert port < jit / 4, (port, jit)
