"""The port's multi-device layer on ``torch.distributed``, held against the
JAX package's SPMD tests (``tests/test_distributed.py``) on the same numpy
inputs, at the reference's own bars.

The JAX side runs once, in one subprocess with 8 fake host devices, and
writes every reference output (and a checkpoint written from its ``(4, 2)``
mesh) to disk. The port runs as jobs of gloo ranks on the CPU
(``repro_torch.launch.mesh.spawn``: fresh processes over a ``FileStore``
under the test's temporary directory, one intra-op thread a rank, a timeout
on the group and on the whole job, every rank killed when one fails):

  * one 8-rank job: the ring matmuls (overlapped and not) on an ``(8,)``
    ``model`` mesh, the gated ring and ``mlp_ring``, ``compressed_psum``
    over an ``(8,)`` ``pod`` group, GPipe on ``(4, 2)`` ``("pod",
    "model")`` (forward and gradients), the granite SMOKE train step on
    ``(4, 2)`` ``("data", "model")``, a live reshard onto ``(2, 4)``, and a
    checkpoint of the sharded state;
  * one 4-rank job on ``(2, 2)``: ``elastic_restore`` of that checkpoint,
    and of the JAX package's, bit for bit, and ``restore(..., mesh=)``;
  * the train driver under 2 ranks against one rank, with ``--resume``.

Each job returns rank 0's results as numpy arrays; the checks run here.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn

SRC = str(Path(__file__).resolve().parent.parent / "src")
JOB_TIMEOUT_S = 300


def _inputs() -> dict:
    """Every numeric input, from one seed (the reference's test shapes)."""
    rng = np.random.default_rng(0)
    f = np.float32
    return {
        # ring matmuls (test_collective_matmul_ring_matches_ref)
        "x": rng.normal(size=(64, 32)).astype(f),
        "w1": rng.normal(size=(32, 48)).astype(f),
        "w2": rng.normal(size=(48, 32)).astype(f),
        # gated ring and mlp_ring
        "g_x": rng.normal(size=(64, 32)).astype(f),
        "g_wg": (rng.normal(size=(32, 48)) * 0.2).astype(f),
        "g_wu": (rng.normal(size=(32, 48)) * 0.2).astype(f),
        "m_x": rng.normal(size=(2, 16, 32)).astype(f),
        "m_wd": (rng.normal(size=(48, 32)) * 0.2).astype(f),
        # cotangents of the rings' outputs (their gradients)
        "ct_y": rng.normal(size=(64, 48)).astype(f),
        "ct_z": rng.normal(size=(64, 32)).astype(f),
        "ct_g": rng.normal(size=(64, 48)).astype(f),
        "ct_m": rng.normal(size=(2, 16, 32)).astype(f),
        # compressed_psum (test_compressed_psum_close_to_exact)
        "c_x": rng.normal(size=(8, 1024)).astype(f),
        # GPipe (test_pipeline_parallel_matches_sequential)
        "p_ws": (rng.normal(size=(8, 16, 16)) * 0.3).astype(f),
        "p_x": rng.normal(size=(6, 2, 4, 16)).astype(f),
    }


JAX_REF = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from repro import sharding as shd
from repro.checkpoint import CheckpointManager
from repro.compat import shard_map
from repro.configs import get_config
from repro.core.collective_matmul import (
    allgather_matmul_gated, mlp_ring, tp_allgather_matmul,
    tp_matmul_reducescatter)
from repro.core.pipeline import pipeline_apply, split_stages
from repro.launch.mesh import make_mesh
from repro.launch.steps import make_train_state
from repro.models import build_model
from repro.optim.compression import compressed_psum

out_dir = sys.argv[1]
inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
out = {}
m8 = make_mesh((8,), ("model",))
x, w1, w2 = (jnp.asarray(inp[k]) for k in ("x", "w1", "w2"))
y = tp_allgather_matmul(x, w1, m8)
out["y"] = y
out["z"] = tp_matmul_reducescatter(y, w2, m8)
out["y_ref"] = tp_allgather_matmul(x, w1, m8, overlapped=False)
out["z_ref"] = tp_matmul_reducescatter(y, w2, m8, overlapped=False)

gx, wg, wu, wd, mx = (jnp.asarray(inp[k])
                      for k in ("g_x", "g_wg", "g_wu", "m_wd", "m_x"))
for act in ("silu", "gelu"):
    out["gated_" + act] = shard_map(
        lambda a, b, c, act=act: allgather_matmul_gated(a, b, c, "model",
                                                        act=act),
        mesh=m8, in_specs=(P("model", None), P(None, "model"),
                           P(None, "model")),
        out_specs=P(None, "model"))(gx, wg, wu)
out["mlp_ring"] = mlp_ring("silu", mx, wg, wu, wd, m8)

# gradients of <output, cotangent> through each ring (jax.grad transposes
# the ppermutes)
ct_y, ct_z, ct_g, ct_m = (jnp.asarray(inp[k])
                          for k in ("ct_y", "ct_z", "ct_g", "ct_m"))
for k, g in zip(("x", "w1"), jax.grad(lambda a, b: jnp.sum(
        tp_allgather_matmul(a, b, m8) * ct_y), (0, 1))(x, w1)):
    out["grad_tp_ag/" + k] = g
for k, g in zip(("y", "w2"), jax.grad(lambda a, b: jnp.sum(
        tp_matmul_reducescatter(a, b, m8) * ct_z), (0, 1))(y, w2)):
    out["grad_tp_rs/" + k] = g
for act in ("silu", "gelu"):
    ring = shard_map(
        lambda a, b, c, act=act: allgather_matmul_gated(a, b, c, "model",
                                                        act=act),
        mesh=m8, in_specs=(P("model", None), P(None, "model"),
                           P(None, "model")), out_specs=P(None, "model"))
    for k, g in zip(("x", "wg", "wu"), jax.grad(lambda a, b, c: jnp.sum(
            ring(a, b, c) * ct_g), (0, 1, 2))(gx, wg, wu)):
        out[f"grad_gated_{act}/" + k] = g
for k, g in zip(("x", "wg", "wu", "wd"), jax.grad(lambda a, b, c, d: jnp.sum(
        mlp_ring("silu", a, b, c, d, m8) * ct_m), (0, 1, 2, 3))(
            mx, wg, wu, wd)):
    out["grad_mlp_ring/" + k] = g

pod = make_mesh((8,), ("pod",))
out["cpsum"] = shard_map(lambda v: compressed_psum(v, "pod"), mesh=pod,
                         in_specs=P("pod", None), out_specs=P("pod", None))(
    jnp.asarray(inp["c_x"]))

pm = make_mesh((4, 2), ("pod", "model"))
ws, px = jnp.asarray(inp["p_ws"]), jnp.asarray(inp["p_x"])

def stage_fn(stage_ws, h):
    h, _ = jax.lax.scan(lambda h, w: (jnp.tanh(h @ w), None), h, stage_ws)
    return h

stages = split_stages(ws, 4)
out["pipe"] = pipeline_apply(stage_fn, stages, px, pm)
out["pipe_grad"] = jax.grad(lambda w_, x_: jnp.sum(
    pipeline_apply(stage_fn, w_, x_, pm) ** 2))(stages, px).reshape(ws.shape)

# a checkpoint written from the (4, 2) mesh, and its state
cfg = get_config("granite_8b", smoke=True)
mesh_a = make_mesh((4, 2), ("data", "model"))
with shd.use_sharding_rules(mesh_a):
    state = make_train_state(build_model(cfg), jax.random.PRNGKey(0))
    shs = shd.named_shardings(jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), state), mesh_a)
    state = jax.tree.map(jax.device_put, state, shs)
mgr = CheckpointManager(os.path.join(out_dir, "ckpt"), async_=False)
mgr.save(state, 7)
mgr.close()
flat, _ = jax.tree_util.tree_flatten_with_path(state)
for kp, leaf in flat:
    key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)
    out["state/" + key] = np.asarray(jnp.asarray(leaf, jnp.float32))
np.savez(os.path.join(out_dir, "ref.npz"),
         **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The inputs on disk, and the JAX reference started beside the port's
    first job (``ref`` waits for it)."""
    d = tmp_path_factory.mktemp("dist")
    np.savez(d / "inputs.npz", **_inputs())
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(JAX_REF),
                             str(d)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        yield d, proc
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref(work):
    d, proc = work
    try:
        out, err = proc.communicate(timeout=JOB_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, f"stdout:\n{out}\nstderr:\n{err}"
    return dict(np.load(d / "ref.npz"))


# ---------------------------------------------------------------------------
# The 8-rank job
# ---------------------------------------------------------------------------

def _granite_step(mesh, compute_dtype, batch, cfg_kw=None, **oc_kw):
    """(plain state, metrics, distributed state, metrics) after one train
    step of granite SMOKE, plain on this rank and distributed on ``mesh``,
    from the same state."""
    from repro_torch import sharding as shd
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_state, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import OptConfig

    cfg = get_config("granite_8b", smoke=True).replace(
        compute_dtype=compute_dtype, **(cfg_kw or {}))
    model = build_model(cfg, "cpu")
    oc = OptConfig(warmup_steps=1, total_steps=10, **oc_kw)
    state = make_train_state(model, torch.Generator().manual_seed(0), oc)
    dstate = shd.distribute_state(state, mesh)
    plain, m1 = make_train_step(model, oc)(state, batch)
    dist_, m2 = make_train_step(model, oc, mesh=mesh)(dstate, batch)
    return plain, m1, dist_, m2


def _job8(work: str):
    import torch.distributed as dist

    from repro_torch import sharding as shd
    from repro_torch.checkpoint import CheckpointManager, reshard_state
    from repro_torch.configs import get_config
    from repro_torch.core import collective_matmul as cm
    from repro_torch.core.pipeline import pipeline_apply, split_stages
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.convert import train_state_to_numpy
    from repro_torch.optim.compression import compressed_psum

    inp = {k: torch.from_numpy(v)
           for k, v in np.load(os.path.join(work, "inputs.npz")).items()}
    out = {}
    rank = dist.get_rank()
    m8 = make_mesh((8,), ("model",), "cpu")
    with torch.no_grad():
        y = cm.tp_allgather_matmul(inp["x"], inp["w1"], m8)
        out["y"] = y.full_tensor()
        out["z"] = cm.tp_matmul_reducescatter(y, inp["w2"], m8).full_tensor()
        out["y_ref"] = cm.tp_allgather_matmul(
            inp["x"], inp["w1"], m8, overlapped=False).full_tensor()
        out["z_ref"] = cm.tp_matmul_reducescatter(
            y, inp["w2"], m8, overlapped=False).full_tensor()
        group = m8.get_group("model")
        rows, cols = slice(rank * 8, rank * 8 + 8), slice(rank * 6, rank * 6 + 6)
        for act in ("silu", "gelu"):
            local = cm.allgather_matmul_gated(
                inp["g_x"][rows], inp["g_wg"][:, cols], inp["g_wu"][:, cols],
                group, act=act)
            parts = [torch.empty_like(local) for _ in range(8)]
            dist.all_gather(parts, local, group=group)
            out["gated_" + act] = torch.cat(parts, dim=1)
        out["mlp_ring"] = cm.mlp_ring(
            "silu", inp["m_x"], inp["g_wg"], inp["g_wu"], inp["m_wd"],
            m8).full_tensor()

    # gradients of <output, cotangent> through each ring: leaves on every
    # rank, the rings' backward running the dual rings
    def leaves(*names):
        return [inp[n].clone().requires_grad_(True) for n in names]

    a, b = leaves("x", "w1")
    (cm.tp_allgather_matmul(a, b, m8).full_tensor() * inp["ct_y"]).sum().backward()
    out["grad_tp_ag/x"], out["grad_tp_ag/w1"] = a.grad, b.grad
    a = (inp["x"] @ inp["w1"]).requires_grad_(True)
    (b,) = leaves("w2")
    (cm.tp_matmul_reducescatter(a, b, m8).full_tensor()
     * inp["ct_z"]).sum().backward()
    out["grad_tp_rs/y"], out["grad_tp_rs/w2"] = a.grad, b.grad
    for act in ("silu", "gelu"):
        a, b, c = leaves("g_x", "g_wg", "g_wu")
        local = cm.allgather_matmul_gated(a[rows], b[:, cols], c[:, cols],
                                          group, act=act)
        (local * inp["ct_g"][:, cols]).sum().backward()
        for k, t in zip(("x", "wg", "wu"), (a, b, c)):
            g = t.grad.clone()   # this rank's rows or columns; sum them
            dist.all_reduce(g, group=group)
            out[f"grad_gated_{act}/" + k] = g
    a, b, c, d = leaves("m_x", "g_wg", "g_wu", "m_wd")
    (cm.mlp_ring("silu", a, b, c, d, m8).full_tensor()
     * inp["ct_m"]).sum().backward()
    for k, t in zip(("x", "wg", "wu", "wd"), (a, b, c, d)):
        out["grad_mlp_ring/" + k] = t.grad

    pod = make_mesh((8,), ("pod",), "cpu")
    out["cpsum"] = compressed_psum(inp["c_x"][rank], pod.get_group("pod"))

    pm = make_mesh((4, 2), ("pod", "model"), "cpu")

    def stage_fn(stage_ws, h):
        for w_ in stage_ws:
            h = torch.tanh(h @ w_)
        return h

    stages = split_stages(inp["p_ws"], 4).clone().requires_grad_(True)
    res = pipeline_apply(stage_fn, stages, inp["p_x"], pm)
    (res ** 2).sum().backward()
    grad = stages.grad.clone()
    dist.all_reduce(grad, group=pm.get_group("pod"))  # each stage's slice
    out["pipe"] = res.detach()
    out["pipe_grad"] = grad.reshape(inp["p_ws"].shape)
    # single-stage sanity of the same code on one rank's view
    ws = inp["p_ws"].clone().requires_grad_(True)
    h = inp["p_x"]
    for w_ in ws:
        h = torch.tanh(h @ w_)
    (h ** 2).sum().backward()
    out["seq"] = h.detach()
    out["seq_grad"] = ws.grad

    mesh_a = make_mesh((4, 2), ("data", "model"), "cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, 512, (4, 32))),
             "labels": torch.as_tensor(rng.integers(0, 512, (4, 32))),
             "mask": torch.ones(4, 32)}
    for dt in ("bfloat16", "float32"):
        plain, m1, dstate, m2 = _granite_step(mesh_a, dt, batch)
        out[f"loss1_{dt}"] = m1["loss"]
        out[f"loss2_{dt}"] = m2["loss"]
    full = shd.full_state(dstate)
    for name, p in plain["params"].named_parameters():
        out["p1/" + name] = p.detach()
        out["p2/" + name] = full["params"].get_parameter(name).detach()
    # remat on the mesh: the f32 sharded step above keeps granite's
    # remat="full" (every block checkpointed on DTensors, its shard_act
    # points inside); the same sharded step without remat
    _, _, nstate, n2 = _granite_step(mesh_a, "float32", batch,
                                     cfg_kw={"remat": "none"})
    out["noremat_step_loss"] = n2["loss"]
    nfull = shd.full_state(nstate)
    out["remat_step_param_err"] = max(
        float((p - nfull["params"].get_parameter(n)).abs().max())
        for n, p in full["params"].named_parameters())
    out["remat_step_moment_err"] = max(
        float((t - nfull["opt"][k][n]).abs().max())
        for k in ("mu", "nu") for n, t in full["opt"][k].items())
    # the Relic-ring MLP trains on the mesh: the step with mlp_tp_overlap
    # against the same sharded step without it
    _, _, rstate, r2 = _granite_step(mesh_a, "float32", batch,
                                     cfg_kw={"mlp_tp_overlap": True})
    out["ring_step_loss"] = r2["loss"]
    rfull = shd.full_state(rstate)
    out["ring_step_param_err"] = max(
        float((p - rfull["params"].get_parameter(n)).abs().max())
        for n, p in full["params"].named_parameters())
    # each rank's attention runs its own heads: q's local head count
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import attention as attn_mod
    heads, full_fn = set(), attn_mod.attention_full

    def recording(q, *a, **kw):
        heads.add(q.shape[2])
        return full_fn(q, *a, **kw)

    hcfg = get_config("granite_8b", smoke=True)
    hmodel = build_model(hcfg, "cpu")
    hparams = shd.distribute_params(
        hmodel.init(torch.Generator().manual_seed(0)), mesh_a)
    attn_mod.attention_full = recording
    try:
        with torch.no_grad(), shd.use_sharding_rules(mesh_a), \
                implicit_replication():
            hmodel.loss(hparams, shd.shard_batch(batch, mesh_a))
    finally:
        attn_mod.attention_full = full_fn
    out["local_heads"] = np.array(sorted(heads))
    out["n_heads"] = hcfg.n_heads
    # placements follow the rules on the 2D mesh
    table = dstate["params"].get_parameter("embed.table")
    out["table_placements"] = np.array(str(table.placements))
    # int8 compression with error feedback on the distributed gradients
    cplain, c1, cdist, c2 = _granite_step(mesh_a, "float32", batch,
                                          compress_grads=True)
    out["closs1"], out["closs2"] = c1["loss"], c2["loss"]
    cfull = shd.full_state(cdist)
    out["cparam_err"] = max(
        float((p - cfull["params"].get_parameter(n)).abs().max())
        for n, p in cplain["params"].named_parameters())
    # The residual keeps what int8 rounding dropped: where the two steps'
    # gradients (equal to f32 rounding) straddle a rounding boundary it
    # differs by one level of its block, at most max|g| / 127 of the leaf.
    from repro_torch.launch.steps import make_train_state
    gmodel = build_model(get_config("granite_8b", smoke=True).replace(
        compute_dtype="float32"), "cpu")
    g0 = make_train_state(gmodel, torch.Generator().manual_seed(0))["params"]
    gmodel.loss(g0, batch)[0].backward()
    ratio, moved, total = 0.0, 0, 0
    for n, r in cplain["opt"]["residual"].items():
        d = (r - cfull["opt"]["residual"][n]).abs()
        level = float(g0.get_parameter(n).grad.abs().max()) / 127
        ratio = max(ratio, float(d.max()) / (level + 1e-6))
        moved += int((d > 1e-5).sum())
        total += d.numel()
    out["cres_ratio"], out["cres_moved"] = ratio, moved / total
    # mlp's Relic-ring branch in a sharded forward (mlp_tp_overlap)
    from torch.distributed.tensor.experimental import implicit_replication
    ring_cfg = get_config("granite_8b", smoke=True).replace(
        compute_dtype="float32", mlp_tp_overlap=True)
    ring_model = build_model(ring_cfg, "cpu")
    rparams = ring_model.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        out["ring_loss1"] = ring_model.loss(rparams, batch)[0]
        with shd.use_sharding_rules(mesh_a), implicit_replication():
            out["ring_loss2"] = ring_model.loss(
                shd.distribute_params(rparams, mesh_a),
                shd.shard_batch(batch, mesh_a))[0].full_tensor()

    # live reshard onto another mesh shape, then a checkpoint of the state
    mesh_c = make_mesh((2, 4), ("data", "model"), "cpu")
    moved = shd.full_state(reshard_state(dstate, mesh_c))
    out["reshard_same"] = np.array(all(
        torch.equal(a, moved["params"].get_parameter(n))
        for n, a in full["params"].named_parameters()) and all(
        torch.equal(t, moved["opt"][k][n])
        for k in full["opt"] for n, t in full["opt"][k].items()))
    mgr = CheckpointManager(os.path.join(work, "ckpt_port"), async_=False)
    mgr.save(train_state_to_numpy(dstate), 9)
    mgr.close()
    if rank != 0:
        return None
    tree = train_state_to_numpy(full)
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat["saved/" + prefix + k] = v

    walk(tree, "")
    out.update(flat)
    return {k: (v.detach().float().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in out.items()}


@pytest.fixture(scope="module")
def port8(work):
    d, _ = work
    return spawn(_job8, 8, str(d), timeout_s=JOB_TIMEOUT_S,
                 store_dir=str(d))[0]


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def test_ring_matmuls_match_plain_and_reference(port8, ref):
    inp = _inputs()
    y_want = inp["x"] @ inp["w1"]
    assert _err(port8["y"], y_want) < 1e-4
    assert _err(port8["z"], y_want @ inp["w2"]) < 1e-3
    assert _err(port8["y_ref"], port8["y"]) < 1e-4
    assert _err(port8["z_ref"], port8["z"]) < 1e-3
    for k, bar in (("y", 1e-4), ("z", 1e-3), ("y_ref", 1e-4), ("z_ref", 1e-3)):
        assert _err(port8[k], ref[k]) < bar, k


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gated_ring_matches_plain_and_reference(port8, ref, act):
    inp = _inputs()
    x = torch.from_numpy(inp["g_x"])
    g = x @ torch.from_numpy(inp["g_wg"])
    g = (torch.nn.functional.silu(g) if act == "silu"
         else torch.nn.functional.gelu(g, approximate="tanh"))
    want = (g * (x @ torch.from_numpy(inp["g_wu"]))).numpy()
    assert _err(port8["gated_" + act], want) < 1e-4
    assert _err(port8["gated_" + act], ref["gated_" + act]) < 1e-4


def test_mlp_ring_matches_plain_and_reference(port8, ref):
    inp = _inputs()
    x = torch.from_numpy(inp["m_x"])
    h = (torch.nn.functional.silu(x @ torch.from_numpy(inp["g_wg"]))
         * (x @ torch.from_numpy(inp["g_wu"])))
    want = (h @ torch.from_numpy(inp["m_wd"])).numpy()
    assert _err(port8["mlp_ring"], want) < 1e-4
    assert _err(port8["mlp_ring"], ref["mlp_ring"]) < 1e-4


@pytest.mark.parametrize("ring", ["tp_ag", "tp_rs", "gated_silu",
                                  "gated_gelu", "mlp_ring"])
def test_ring_gradients_match_reference(port8, ref, ring):
    keys = [k for k in ref if k.startswith(f"grad_{ring}/")]
    assert keys
    for k in keys:
        assert _err(port8[k], ref[k]) < 1e-4, k


def test_compressed_psum_close_to_exact_and_reference(port8, ref):
    x = _inputs()["c_x"]
    want = x.sum(0)
    scale = float(np.abs(x).max()) / 127
    assert _err(port8["cpsum"], want) <= 8 * scale + 1e-6
    # rank 0's row of the reference's (replicated) result
    assert _err(port8["cpsum"], ref["cpsum"][0]) <= 1e-5


def test_pipeline_forward_and_grads(port8, ref):
    assert _err(port8["pipe"], port8["seq"]) < 1e-6
    assert _err(port8["pipe_grad"], port8["seq_grad"]) < 1e-4
    assert _err(port8["pipe"], ref["pipe"]) < 1e-6
    assert _err(port8["pipe_grad"], ref["pipe_grad"]) < 1e-4


def test_granite_2d_train_step_matches_single_device(port8):
    l1, l2 = float(port8["loss1_bfloat16"]), float(port8["loss2_bfloat16"])
    assert abs(l1 - l2) / abs(l1) < 5e-2, (l1, l2)
    l1, l2 = float(port8["loss1_float32"]), float(port8["loss2_float32"])
    assert abs(l1 - l2) < 1e-5, (l1, l2)
    names = [k[3:] for k in port8 if k.startswith("p1/")]
    assert names
    for n in names:
        assert _err(port8["p1/" + n], port8["p2/" + n]) < 1e-5, n
    assert port8["table_placements"] == "(Shard(dim=1), Shard(dim=0))"


def test_attention_runs_each_ranks_heads(port8):
    # granite SMOKE's 4 heads over model = 2: two heads a rank, not all four
    assert list(port8["local_heads"]) == [int(port8["n_heads"]) // 2]


def test_mlp_ring_train_step_matches_plain_sharded_step(port8):
    assert abs(float(port8["ring_step_loss"])
               - float(port8["loss2_float32"])) < 1e-5
    assert float(port8["ring_step_param_err"]) < 1e-5


def test_remat_train_step_matches_plain_sharded_step(port8):
    from repro_torch.configs import get_config

    assert get_config("granite_8b", smoke=True).remat == "full"
    assert abs(float(port8["noremat_step_loss"])
               - float(port8["loss2_float32"])) < 1e-5
    assert float(port8["remat_step_param_err"]) < 1e-5
    assert float(port8["remat_step_moment_err"]) < 1e-5


def test_compressed_train_step_on_the_mesh(port8):
    assert abs(float(port8["closs1"]) - float(port8["closs2"])) < 1e-5
    assert float(port8["cparam_err"]) < 1e-5
    assert float(port8["cres_ratio"]) <= 1.0       # one level at most
    assert float(port8["cres_moved"]) < 1e-3       # and rarely


def test_mlp_ring_branch_in_a_sharded_forward(port8):
    l1, l2 = float(port8["ring_loss1"]), float(port8["ring_loss2"])
    assert abs(l1 - l2) < 1e-5, (l1, l2)


def test_live_reshard_is_exact(port8):
    assert bool(port8["reshard_same"])


# ---------------------------------------------------------------------------
# The 4-rank job: elastic restore onto (2, 2)
# ---------------------------------------------------------------------------

def _job4(work: str):
    import torch.distributed as dist

    from repro_torch import sharding as shd
    from repro_torch.checkpoint import CheckpointManager, elastic_restore
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_train_state
    from repro_torch.models import build_model
    from repro_torch.models.convert import (train_state_keys,
                                            train_state_to_numpy)

    cfg = get_config("granite_8b", smoke=True)
    template = make_train_state(build_model(cfg, "meta"),
                                torch.Generator().manual_seed(0))
    mesh_b = make_mesh((2, 2), ("data", "model"), "cpu")
    out = {}
    for tag in ("port", "jax"):
        mgr = CheckpointManager(os.path.join(work, "ckpt_" + tag
                                             if tag == "port" else "ckpt"),
                                async_=False)
        state, step = elastic_restore(mgr, template, mesh_b)
        table = state["params"].get_parameter("embed.table")
        out[f"{tag}/step"] = step
        out[f"{tag}/on_b"] = (table.device_mesh.shape == (2, 2)
                              and table.to_local().shape == (256, 32))
        tree = train_state_to_numpy(shd.full_state(state))
        out[f"{tag}/tree"] = tree
        if tag == "jax":
            placed, _ = mgr.restore(train_state_keys(template), device="cpu",
                                    mesh=mesh_b)
            t = placed["params"]["embed"]["table"]
            out["placed_table"] = (str(t.placements), t.full_tensor().numpy())
        mgr.close()
    return out if dist.get_rank() == 0 else None


@pytest.fixture(scope="module")
def port4(work, port8, ref):
    d, _ = work
    return spawn(_job4, 4, str(d), timeout_s=JOB_TIMEOUT_S,
                 store_dir=str(d))[0]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_elastic_restore_across_mesh_shapes_is_bit_exact(port8, port4):
    assert port4["port/step"] == 9 and port4["port/on_b"]
    got = _flat(port4["port/tree"])
    saved = {k[len("saved/"):]: v for k, v in port8.items()
             if k.startswith("saved/")}
    assert set(got) == set(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(got[k].astype(np.float32), v, err_msg=k)


def test_elastic_restore_of_the_reference_checkpoint(ref, port4):
    assert port4["jax/step"] == 7 and port4["jax/on_b"]
    got = _flat(port4["jax/tree"])
    want = {k[len("state/"):]: v for k, v in ref.items()
            if k.startswith("state/")}
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].astype(np.float32), v, err_msg=k)


def test_restore_onto_a_mesh_places_by_rule(ref, port4):
    placements, table = port4["placed_table"]
    assert placements == "(Shard(dim=1), Shard(dim=0))"
    np.testing.assert_array_equal(table, ref["state/params/embed/table"])


# ---------------------------------------------------------------------------
# The train driver under 2 ranks
# ---------------------------------------------------------------------------

def _driver_args(ckpt: str, steps: int, resume: bool):
    args = ["--arch", "relic_tiny", "--smoke", "--steps", str(steps),
            "--batch", "4", "--seq", "32", "--log-every", "2",
            "--device", "cpu", "--ckpt", ckpt, "--ckpt-every", "3"]
    return args + (["--resume"] if resume else [])


def _driver_job(ckpt: str, steps: int, resume: bool):
    from repro_torch.launch import train
    return train.main(_driver_args(ckpt, steps, resume))


def test_train_driver_two_ranks_matches_one(work, capsys):
    from repro_torch.launch import train

    work, _ = work
    one = str(work / "drv1")
    two = str(work / "drv2")
    l1 = train.main(_driver_args(one, 6, False))
    l2 = spawn(_driver_job, 2, two, 6, False, timeout_s=JOB_TIMEOUT_S,
               store_dir=str(work))
    assert l2[0] == l2[1]
    # bf16 compute: the sharded sums round in another order (8 bits of
    # mantissa); the reference holds its 2D step at 5e-2
    assert abs(l1 - l2[0]) / abs(l1) < 1e-2, (l1, l2)
    # both resume from step 6 and train on to 8
    r1 = train.main(_driver_args(one, 8, True))
    r2 = spawn(_driver_job, 2, two, 8, True, timeout_s=JOB_TIMEOUT_S,
               store_dir=str(work))
    assert "resumed from step 6" in capsys.readouterr().out
    assert abs(r1 - r2[0]) / abs(r1) < 1e-2, (r1, r2)
