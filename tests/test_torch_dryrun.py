"""The port's dry-run (``repro_torch.launch.dryrun``) held against the JAX
package's (``repro.launch.dryrun``) on the same cells.

The JAX side runs once, in one subprocess with 8 fake host devices, and
writes what it computes to disk: ``count_params`` and ``model_flops`` for
every arch and shape, ``input_specs``, ``parse_collectives`` of synthetic
HLO lines, and the reference test's cell (``tests/test_distributed.py::
test_dryrun_single_cell_on_8_devices``: granite_8b SMOKE on ``(4, 2)``,
train_4k cut to seq 128 and batch 8) lowered and compiled. The port's side
runs here, over a fake process group that each test destroys, and in one
job of 8 gloo ranks for the mesh serve step's tokens.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_production_mesh, spawn
from repro_torch.models import build_model

SRC = str(Path(__file__).resolve().parent.parent / "src")
JOB_TIMEOUT_S = 300
DTYPE_BYTES = {"bf16": 2, "f32": 4, "s32": 4}
CELL = dataclasses.replace(SHAPES["train_4k"], seq_len=128, global_batch=8)
# granite_8b SMOKE's decode_32k cell at two cache lengths, batch 8
DECODE_T = (4096, 8192)


def _hlo_lines():
    """(line, kind, result bytes, group) for each collective kind, in each
    form of replica groups the reference parses ([n,g]<=[...], an explicit
    list, none), as ``-start`` ops too."""
    out = []
    forms = [(", replica_groups=[2,4]<=[8]", 4),
             (", replica_groups={{0,1},{2,3},{4,5},{6,7}}", 2), ("", 2)]
    kinds = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")
    for i, kind in enumerate(kinds):
        for j, (groups, g) in enumerate(forms):
            dtype, dims = ("bf16", (8, 1024)) if j % 2 else ("f32", (4, 96, 3))
            start = "-start" if i % 2 == j % 2 else ""
            shp = ",".join(map(str, dims))
            line = (f"  %c{i}{j} = {dtype}[{shp}]{{1,0}} {kind}{start}("
                    f"{dtype}[{shp}]{{1,0}} %p){groups}, "
                    f"metadata={{op_name=\"x\"}}")
            out.append((line, kind, DTYPE_BYTES[dtype] * int(np.prod(dims)),
                        g))
    return out


REF = """
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from repro.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro.launch import dryrun as dr
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
from repro.compat import cost_analysis
from repro.launch.mesh import make_mesh
from repro.models import build_model

out_dir = sys.argv[1]
lines = json.load(open(os.path.join(out_dir, "lines.json")))
out = {"params": {}, "flops": {}, "specs": {}, "colls": []}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    out["params"][arch] = [dr.count_params(cfg),
                           dr.count_params(cfg, active_only=True)]
    model = build_model(cfg)
    for name, shape in SHAPES.items():
        if not shape_applicable(cfg, shape)[0]:
            continue
        out["flops"][f"{arch}/{name}"] = dr.model_flops(cfg, shape)
        batch, cache_len = model.input_specs(shape)
        out["specs"][f"{arch}/{name}"] = [
            {k: [list(v.shape), str(v.dtype)] for k, v in batch.items()},
            cache_len]
for line in lines:
    out["colls"].append(dr.parse_collectives(line))

cfg = get_config("granite_8b", smoke=True).replace(scan_layers=True)
mesh = make_mesh((4, 2), ("data", "model"))
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=128, global_batch=8)
_, compiled, _ = dr.lower_cell(cfg, shape, mesh)
out["cell"] = {
    "argument_bytes": int(compiled.memory_analysis().argument_size_in_bytes),
    "flops": float(cost_analysis(compiled).get("flops", 0.0)),
    "collective_bytes": dr.parse_collectives(compiled.as_text())["total"],
}
out["decode"] = {}
for t in DECODE_T:
    shape = dataclasses.replace(SHAPES["decode_32k"], seq_len=t,
                                global_batch=8)
    _, compiled, _ = dr.lower_cell(dr._prep_cfg(cfg, shape, scan=True),
                                   shape, mesh)
    out["decode"][str(t)] = dr.parse_collectives(compiled.as_text())
json.dump(out, open(os.path.join(out_dir, "ref.json"), "w"))
"""


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The synthetic lines on disk, and the JAX reference started at once
    (``ref`` waits for it)."""
    d = tmp_path_factory.mktemp("dryrun")
    (d / "lines.json").write_text(json.dumps([x[0] for x in _hlo_lines()]))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    script = f"DECODE_T = {DECODE_T!r}\n" + textwrap.dedent(REF)
    proc = subprocess.Popen([sys.executable, "-c", script, str(d)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
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
    return json.loads((d / "ref.json").read_text())


@pytest.fixture()
def fake8():
    """A fake group of 8 ranks and the reference test's (4, 2) mesh; the
    group is destroyed after the test (test files share a worker)."""
    with dr.fake_group(8):
        yield dist.device_mesh.init_device_mesh(
            "cpu", (4, 2), mesh_dim_names=("data", "model"))


# ---------------------------------------------------------------------------
# Pure arithmetic: parameters, model FLOPs, input specs, wire bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_count_params_and_model_flops_match_reference(ref, arch):
    cfg = get_config(arch)
    assert [dr.count_params(cfg), dr.count_params(cfg, active_only=True)] \
        == ref["params"][arch]
    for name, shape in SHAPES.items():
        if shape_applicable(cfg, shape)[0]:
            assert dr.model_flops(cfg, shape) == ref["flops"][f"{arch}/{name}"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(ref, arch):
    cfg = get_config(arch)
    model = build_model(cfg, "meta")
    for name, shape in SHAPES.items():
        if not shape_applicable(cfg, shape)[0]:
            continue
        batch, cache_len = model.input_specs(shape)
        want, want_len = ref["specs"][f"{arch}/{name}"]
        assert cache_len == want_len
        assert {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
                for k, v in batch.items()} == want, (arch, name)
        assert all(v.is_meta for v in batch.values())


def test_wire_bytes_match_parse_collectives(ref):
    for (line, kind, size, group), parsed in zip(_hlo_lines(), ref["colls"]):
        assert parsed["counts"][kind] == 1, line
        assert dr.wire_bytes(kind, size, group) == parsed[kind], line
        assert parsed["total"] == parsed[kind], line


# ---------------------------------------------------------------------------
# The production mesh and the reference test's cell
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_over_the_fake_group(multi_pod):
    shape, axes = ((2, 16, 16), ("pod", "data", "model")) if multi_pod \
        else ((16, 16), ("data", "model"))
    with pytest.raises(RuntimeError):       # no group
        make_production_mesh(multi_pod=multi_pod, device="cpu")
    with dr.fake_group(int(np.prod(shape))):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        assert tuple(mesh.shape) == shape and mesh.mesh_dim_names == axes
    with dr.fake_group(128), pytest.raises(RuntimeError):
        make_production_mesh(multi_pod=multi_pod, device="cpu")
    assert not dist.is_initialized()


def test_reference_cell_bytes_flops_and_collectives(ref, fake8):
    cfg = get_config("granite_8b", smoke=True)
    rec = dr.analyze_cell(cfg, CELL, fake8)
    mem, dev = rec["memory"], rec["per_device"]
    assert mem["argument_bytes"] > 0 and dev["hlo_flops"] > 0
    assert dev["collective_wire_bytes"] > 0
    assert mem["peak_bytes_est"] >= mem["argument_bytes"]
    # The reference's arguments hold its int32 step; the port's step is a
    # Python int, outside any tensor.
    step_bytes = 4
    assert mem["argument_bytes"] + step_bytes \
        == ref["cell"]["argument_bytes"]
    # Each rank computes its share: 8 ranks' FLOPs are the one-process
    # step's (attention per head shard, the products by their shards).
    one = dr.analyze_cell(cfg, CELL, None)["per_device"]["hlo_flops"]
    assert abs(8 * dev["hlo_flops"] - one) <= 0.01 * one, (dev["hlo_flops"],
                                                           one)


def test_decode_cell_keeps_the_cache_where_it_is(ref, fake8):
    # granite SMOKE's decode on (4, 2): the cache's time axis over "model"
    # stays there (split-T: only q's heads and the softmax partials move),
    # so the collective bytes do not grow with the cache, and they stay
    # within 1.25x of the reference's lowered cell at each length.
    cfg = get_config("granite_8b", smoke=True)
    got = {}
    for t in DECODE_T:
        shape = dataclasses.replace(SHAPES["decode_32k"], seq_len=t,
                                    global_batch=8)
        dev = dr.analyze_cell(dr._prep_cfg(cfg, shape), shape,
                              fake8)["per_device"]
        got[t] = dev["collective_wire_bytes"]
        want = ref["decode"][str(t)]["total"]
        assert 0 < got[t] <= 1.25 * want, (t, got[t], want)
    assert len(set(got.values())) == 1, got
    # the meter sees split-T's all-reduces at the ring factors: per layer
    # the f32 max and sum [2, 1, 4] and the output [2, 1, 4, 16] of a
    # rank's 2 batch rows and 4 heads, over "model" = 2
    dev = dr.analyze_cell(dr._prep_cfg(cfg, shape), shape, fake8,
                          sites=True)["per_device"]
    b, h, hd = 8 // 4, cfg.n_heads, cfg.resolved_head_dim
    partials = sum(dr.wire_bytes("all-reduce", n * 4, 2)
                   for n in (b * h, b * h, b * h * hd))
    assert dev["collective_by_site"][
        "models/attention.py:combine_partials forward"] \
        == cfg.n_layers * partials


# Collective wire bytes before the vocab-parallel loss (this file's
# analyze_cell at the commit before it): the CELL's by kind on fake8, and
# granite_8b train_4k's on the pod mesh (``python -m
# repro_torch.launch.dryrun --arch granite_8b --shape train_4k --mesh pod
# --force``). The loss gathered each rank's logits from their vocab slices.
GATHERED_LOSS_BYTES = {"all-gather": 1_877_632.0, "all-reduce": 198_572.0,
                       "reduce-scatter": 1_049_600.0}
GATHERED_LOSS_POD_BYTES = 1_215_364_224_060.0


def test_train_cell_loses_the_logits_gather(fake8):
    # The loss keeps the logits' vocab sharded: the all-gather of a rank's
    # [2, 128, 512] f32 logits from vocab slices of 256 over "model" goes.
    # Its backward was free (DTensor slices the gathered gradient back to
    # the shards), and stays so. Three all-reduces of a [2, 128] f32
    # partial over "model" (the max, the sum of exp, the label's logit) are
    # all that replace it.
    cfg = get_config("granite_8b", smoke=True)
    dev = dr.analyze_cell(cfg, CELL, fake8)["per_device"]
    data, p = 4, 2                                  # the (4, 2) mesh
    rows = CELL.global_batch // data * CELL.seq_len
    gather = dr.wire_bytes("all-gather", rows * cfg.vocab_size * 4, p)
    backward = 0
    partials = 3 * dr.wire_bytes("all-reduce", rows * 4, p)
    assert gather == 262_144
    kind = dev["collective_by_kind"]
    before = GATHERED_LOSS_BYTES
    assert before["all-gather"] - kind["all-gather"] >= gather + backward
    assert sum(before.values()) - dev["collective_wire_bytes"] \
        >= gather + backward
    assert kind["all-reduce"] - before["all-reduce"] == partials
    assert kind["reduce-scatter"] == before["reduce-scatter"]


def test_collective_bytes_by_site(fake8):
    # With sites the same step's bytes are summed by the port's call site
    # that issued them: they add up to the total, the backward's collectives
    # are named by the forward code that recorded them, and the loss's three
    # [2, 128] f32 all-reduces by the vocab-parallel combine.
    cfg = get_config("granite_8b", smoke=True)
    plain = dr.analyze_cell(cfg, CELL, fake8)["per_device"]
    dev = dr.analyze_cell(cfg, CELL, fake8, sites=True)["per_device"]
    sites = dev["collective_by_site"]
    assert dev["collective_wire_bytes"] == plain["collective_wire_bytes"]
    assert sum(sites.values()) == dev["collective_wire_bytes"]
    assert list(sites.values()) == sorted(sites.values(), reverse=True)
    assert not any(k.startswith("None") for k in sites), sites
    assert {k.rsplit(" ", 1)[1] for k in sites} \
        == {"forward", "backward", "recompute"}
    rows = CELL.global_batch // 4 * CELL.seq_len
    assert sites["models/layers.py:combine_vocab_partials forward"] \
        == 3 * dr.wire_bytes("all-reduce", rows * 4, 2)


@pytest.fixture(scope="module")
def pod_cells():
    """granite_8b's decode_32k and train_4k on the 16 x 16 pod mesh (a fake
    group of 256 ranks, meta tensors), as the dry-run costs them."""
    cfg = get_config("granite_8b")
    out = {}
    with dr.fake_group(256):
        mesh = make_production_mesh(device="cpu")
        for name in ("decode_32k", "train_4k"):
            shape = SHAPES[name]
            out[name] = dr.analyze_cell(dr._prep_cfg(cfg, shape), shape,
                                        mesh)["per_device"]
    return out


def test_pod_decode_cell_moves_no_cache(pod_cells):
    # Gathering every layer's K and V over "model" was 3.62e10 bytes a
    # device (36 layers x K, V x 8 kv heads x 128 x bf16 x 32768 positions x
    # 8 rows a rank x 15/16); split-T moves q and the partials only.
    cfg = get_config("granite_8b")
    cache = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.resolved_head_dim * 2 \
        * SHAPES["decode_32k"].seq_len * SHAPES["decode_32k"].global_batch \
        // 16
    gathered = dr.wire_bytes("all-gather", cache, 16)
    got = pod_cells["decode_32k"]["collective_wire_bytes"]
    assert got < 1e9 < gathered, (got, gathered)


def test_pod_train_cell_loses_the_logits_moves(pod_cells):
    # At train_4k (batch 256: 16 rows of 4096 a rank) the unembedding's
    # product over the model-sharded d_model left f32 partial sums of every
    # vocab column, reduce-scattered to the vocab shards, and the loss
    # gathered them back. The product now reads its bf16 input gathered
    # and yields its vocab columns whole, and the loss keeps the shards.
    cfg, m = get_config("granite_8b"), 16
    logits = 16 * SHAPES["train_4k"].seq_len * cfg.vocab_size * 4
    moved = dr.wire_bytes("reduce-scatter", logits // m, m) \
        + dr.wire_bytes("all-gather", logits, m)
    got = pod_cells["train_4k"]["collective_wire_bytes"]
    assert GATHERED_LOSS_POD_BYTES - got >= moved, (got, moved)


def test_ring_cell_costs_each_hop_as_a_collective_permute(fake8):
    # The same cell with mlp_tp_overlap=True: the Relic rings run on meta
    # tensors (nothing is sent) and the meter counts each hop as a
    # collective-permute of the buffer it moves, the buffer once.
    cfg = get_config("granite_8b", smoke=True)
    plain = dr.analyze_cell(cfg, CELL, fake8)["per_device"]
    ring = dr.analyze_cell(cfg.replace(mlp_tp_overlap=True), CELL,
                           fake8)["per_device"]
    data, p = 4, 2                                   # the (4, 2) mesh
    rows = CELL.global_batch // data * CELL.seq_len  # a rank's ring rows
    chunk = rows // p * cfg.d_model                  # one x or z chunk
    act = torch.empty((), dtype=getattr(torch, cfg.compute_dtype)).element_size()
    acc = 4                                          # the f32 accumulator
    # A layer runs four all-gather rings of compute-dtype chunks, p - 1
    # hops each (the gated forward, the gated backward's pass over x, and
    # the down product's two backward rings over dz), and two
    # reduce-scatter rings of f32 chunks, p hops each (the down product,
    # and the gated backward's dx). Under the config's remat="full" the
    # backward recomputes the block's forward, so the gated forward's and
    # the down product's rings run once more.
    assert cfg.remat == "full"
    hops = cfg.n_layers * (5 * (p - 1) + 3 * p)
    moved = cfg.n_layers * (5 * (p - 1) * chunk * act + 3 * p * chunk * acc)
    assert plain["collective_counts"]["collective-permute"] == 0
    assert ring["collective_counts"]["collective-permute"] == hops
    assert ring["collective_by_kind"]["collective-permute"] == moved
    # The rings compute the same products on the same shards, and the gated
    # backward recomputes each chunk's gate and up products (it keeps no
    # gathered activations): two [rows, d_model] @ [d_model, d_ff / p]
    # products a layer more. The remat recompute stops once the backward
    # has what it needs: the plain block's down product, its last op, is
    # not rerun, but the ring's is, inside the one ring call that the
    # recompute reruns: one [rows, d_ff / p] @ [d_ff / p, d_model] more.
    recompute = cfg.n_layers * 3 * (2 * rows * cfg.d_model * cfg.d_ff // p)
    assert ring["hlo_flops"] == plain["hlo_flops"] + recompute


def test_remat_cell_costs_the_recompute(fake8, monkeypatch):
    # The same cell under each remat policy. "full" runs every block's
    # forward twice: its FLOPs are the cell's without remat plus each
    # block's forward FLOPs counted alone (a meter of its own around each
    # block call), less what the recompute need not rerun: it stops once
    # the backward has what it needs, before the block's last product, the
    # MLP's down projection ([rows, d_ff / p] @ [d_ff / p, d_model] on a
    # rank). Keeping fewer activations, it holds the fewest temp bytes;
    # "dots" keeps the 2-D products' outputs besides.
    from repro_torch.models import lm

    cfg = get_config("granite_8b", smoke=True)
    recs = {pol: dr.analyze_cell(cfg.replace(remat=pol), CELL, fake8)
            for pol in ("full", "dots")}
    blocks, plain_remat = [], lm._remat

    def metered(policy, fn):
        inner = plain_remat(policy, fn)

        def call(*args, **kwargs):
            with dr._Meter() as m:
                out = inner(*args, **kwargs)
            blocks.append(m.flops)
            return out
        return call

    monkeypatch.setattr(lm, "_remat", metered)
    recs["none"] = dr.analyze_cell(cfg.replace(remat="none"), CELL, fake8)
    assert len(blocks) == cfg.n_layers
    data, p = 4, 2                                   # the (4, 2) mesh
    rows = CELL.global_batch // data * CELL.seq_len
    tail = cfg.n_layers * 2 * rows * (cfg.d_ff // p) * cfg.d_model
    flops = {k: r["per_device"]["hlo_flops"] for k, r in recs.items()}
    assert flops["full"] == flops["none"] + sum(blocks) - tail
    assert flops["none"] < flops["dots"] < flops["full"]
    temp = {k: r["memory"]["temp_bytes"] for k, r in recs.items()}
    assert temp["full"] < temp["dots"] < temp["none"], temp


# ---------------------------------------------------------------------------
# The steps on a mesh: 8 gloo ranks against the plain steps
# ---------------------------------------------------------------------------

DECODE_STEPS = 8
FAMILIES = [a for a in ARCH_IDS if a != "relic_tiny"]
# Positions in a 16-long cache that "model" = 2 splits into [0, 8) and
# [8, 16): two in the first shard, either side of the boundary, two in the
# last shard (the prompt forced at the first four).
SPLIT_POSITIONS = (0, 3, 7, 8, 12, 15)


def _batch(cfg, rng, b, s):
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s))),
             "labels": torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s))),
             "mask": torch.ones(b, s)}
    if cfg.family == "encdec":
        batch["frames"] = torch.as_tensor(rng.normal(size=(
            b, cfg.frontend.n_tokens, cfg.d_model)), dtype=torch.float32)
    if cfg.family == "vlm":
        batch["patches"] = torch.as_tensor(rng.normal(size=(
            b, cfg.frontend.n_tokens, cfg.frontend.embed_dim)),
            dtype=torch.float32)
    return batch


def _decode(model, params, mesh, prompt, steps, cache_len=16, frames=None):
    """Greedy tokens and logits of serve steps from ``prompt``'s first token
    (the prompt forced at its first positions), plain or on ``mesh``, at
    positions ``range(steps)`` or the positions ``steps`` lists; with
    ``frames`` the encoder-decoder's cross caches are written first; with
    the mesh, also the logits' and the cache's placements."""
    from repro_torch import sharding as shd
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.encdec import encode, prefill_cross_cache

    cache = model.init_cache(prompt.shape[0], cache_len)
    if frames is not None:
        with torch.no_grad():
            cache = prefill_cross_cache(model.cfg, params, cache,
                                        encode(model.cfg, params, frames))
    if mesh is not None:
        params = shd.distribute_params(params, mesh)
        cache = shd.distribute_cache(cache, mesh)
    step = make_serve_step(model, mesh)
    tok, toks, logits, placed = prompt[:, :1], [], [], None
    positions = range(steps) if isinstance(steps, int) else steps
    for i, pos in enumerate(positions):
        if i < prompt.shape[1]:
            tok = prompt[:, i:i + 1]
        tok, lg, cache = step(params, cache, tok, pos)
        if mesh is not None:
            k = cache["layers"].get("cache", cache["layers"]).get("k")
            placed = (str(lg.placements),
                      None if k is None else str(k.placements))
            tok, lg = tok.full_tensor(), lg.full_tensor()
        toks.append(tok)
        logits.append(lg)
    return torch.cat(toks, 1).numpy(), torch.cat(logits, 1).numpy(), placed


def _mesh_job():
    """granite SMOKE served on (4, 2) against plain; then every family's
    sharded train step and serve step against its plain steps (f32), the
    serve step also at positions across the cache's shards, with the calls
    of split-T, of the per-head path and of the vocab-parallel loss
    counted."""
    from repro_torch import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_train_state, make_train_step
    from repro_torch.models import attention as attn
    from repro_torch.models import layers as L
    from repro_torch.optim import OptConfig

    calls = {"split": 0, "per_head": 0, "vocab": 0}

    def counted(mod, name, key):
        plain = getattr(mod, name)

        def call(*args, **kwargs):
            calls[key] += 1
            return plain(*args, **kwargs)
        setattr(mod, name, call)

    counted(attn, "combine_partials", "split")
    counted(attn, "_per_head_shard", "per_head")
    counted(L, "combine_vocab_partials", "vocab")

    def delta(fn):
        before = dict(calls)
        out = fn()
        return out, {k: calls[k] - before[k] for k in calls}

    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    rng = np.random.default_rng(0)
    out = {}
    cfg = get_config("granite_8b", smoke=True).replace(compute_dtype="float32")
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (8, 4)))
    out["granite"] = [_decode(model, params, m, prompt, DECODE_STEPS)
                      for m in (None, mesh)]
    oc = OptConfig(warmup_steps=1, total_steps=10)
    for arch in FAMILIES:
        cfg = get_config(arch, smoke=True).replace(compute_dtype="float32")
        model = build_model(cfg, "cpu")
        batch = _batch(cfg, rng, 8, 16)
        state = make_train_state(model, torch.Generator().manual_seed(0))
        dstate = shd.distribute_state(state, mesh)
        plain, m1 = make_train_step(model, oc)(state, batch)
        (sharded, m2), train_calls = delta(
            lambda: make_train_step(model, oc, mesh=mesh)(dstate, batch))
        full = shd.full_state(sharded)["params"]
        rec = {"loss": (float(m1["loss"]), float(m2["loss"])),
               "param_err": max(
                   float((p.detach() - full.get_parameter(n)).abs().max())
                   for n, p in plain["params"].named_parameters()),
               "train_calls": train_calls}
        params = model.init(torch.Generator().manual_seed(0))
        frames = batch.get("frames")
        for key, steps in (("tokens", 4), ("split", SPLIT_POSITIONS)):
            toks = [_decode(model, params, None, batch["tokens"], steps,
                            frames=frames)[0]]
            res, rec[f"{key}_calls"] = delta(lambda: _decode(
                model, params, mesh, batch["tokens"], steps, frames=frames))
            rec[key] = toks + [res[0]]
        out[arch] = rec
    return out if dist.get_rank() == 0 else None


@pytest.fixture(scope="module")
def mesh_job(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_job")
    return spawn(_mesh_job, 8, timeout_s=JOB_TIMEOUT_S, store_dir=str(d))[0]


def test_serve_step_on_the_mesh_gives_the_plain_tokens(mesh_job):
    (t1, l1, _), (t2, l2, placed) = mesh_job["granite"]
    np.testing.assert_array_equal(t1, t2)
    assert float(np.abs(l1 - l2).max()) < 1e-4
    # the reference's decode logits [batch axes, None, "model"]; the cache
    # rules: batch over data, time over model (layers stacked in front)
    assert placed == ("(Shard(dim=0), Shard(dim=2))",
                      "(Shard(dim=1), Shard(dim=2))")


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_family_trains_and_serves_on_the_mesh(mesh_job, arch):
    """Every family's step runs sharded, as the dry-run's cells need, and
    agrees with the plain step: the loss at 1e-5, the parameters after one
    AdamW step well inside its 3e-4 learning rate, the greedy tokens
    exactly."""
    rec = mesh_job[arch]
    l1, l2 = rec["loss"]
    assert abs(l1 - l2) < 1e-5, (l1, l2)
    assert rec["param_err"] < 1e-4
    np.testing.assert_array_equal(*rec["tokens"])
    # the loss over the vocab shards, once a step
    assert rec["train_calls"]["vocab"] == 1, rec["train_calls"]


def _attention_reads(cfg) -> int:
    """Attention calls of one decode step: each layer's (the decoder's self
    and cross attention), the hybrid's shared block per full group."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "encdec":
        return 2 * cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_family_serves_across_the_cache_shards(mesh_job, arch):
    """The serve step at positions in the first shard of the cache's time
    axis, either side of the boundary and in the last shard gives the plain
    step's greedy tokens exactly; every attention read of a cache took
    split-T, none the per-head path, at both sets of positions."""
    rec = mesh_job[arch]
    np.testing.assert_array_equal(*rec["split"])
    cfg = get_config(arch, smoke=True)
    for key, steps in (("tokens_calls", 4), ("split_calls",
                                             len(SPLIT_POSITIONS))):
        assert rec[key]["split"] == steps * _attention_reads(cfg), (key,
                                                                    rec[key])
        assert rec[key]["per_head"] == 0, (key, rec[key])
