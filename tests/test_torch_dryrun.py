"""The port's dry-run (``repro_torch.launch.dryrun``) held against the JAX
package's (``repro.launch.dryrun``) on the same cells.

The JAX side runs in three subprocesses, started together, and writes
what it computes to disk. With 8 fake host devices: ``count_params`` and
``model_flops`` for every arch and shape, ``input_specs``,
``parse_collectives`` of synthetic HLO lines and the reference test's cell
(``tests/test_distributed.py::test_dryrun_single_cell_on_8_devices``:
granite_8b SMOKE on ``(4, 2)``, train_4k cut to seq 128 and batch 8)
lowered and compiled (``REF``); the depth-exact collective counts of the
SMOKE cells on ``(4, 2)``: every family's train cell, granite's at 2 and 3
layers and at seq 128 and 1024, its decode cell at two cache lengths
(``REF_DEPTH``). Depth-exact: lowered with the layers unrolled
(``_prep_cfg(..., scan=False)``), since ``parse_collectives`` counts a
scanned layer loop's body once whatever the depth. With the 512 host
devices that ``repro.launch.dryrun`` sets: granite_8b's pod cells by
``_cost_points``, the counts the reference's records hold (two unrolled
depths, extrapolated; ``REF_POD``). None writes a record (no
``run_cell``). The port's side runs here, over a fake process group that
each test destroys, and in jobs of gloo ranks.
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
# granite_8b SMOKE's train cell at these sequence lengths and depths
GRANITE_SEQ = (128, 1024)
GRANITE_LAYERS = (2, 3)


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
}
json.dump(out, open(os.path.join(out_dir, "ref.json"), "w"))
"""

# The depth-exact collective counts of the SMOKE cells on (4, 2): the
# layers unrolled, since parse_collectives counts a scanned layer loop once.
REF_DEPTH = """
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from repro.configs import ARCH_IDS, SHAPES, get_config
from repro.launch import dryrun as dr
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
from repro.launch.mesh import make_mesh

out_dir = sys.argv[1]
mesh = make_mesh((4, 2), ("data", "model"))
cfg = get_config("granite_8b", smoke=True)
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=128, global_batch=8)
out = {}


def unrolled(c, shape):
    _, compiled, _ = dr.lower_cell(dr._prep_cfg(c, shape, scan=False),
                                   shape, mesh)
    return dr.parse_collectives(compiled.as_text())


out["train"] = {arch: unrolled(get_config(arch, smoke=True), shape)
                for arch in ARCH_IDS}
out["granite"] = {}
for s in GRANITE_SEQ:
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=s, global_batch=8)
    for n in GRANITE_LAYERS:
        out["granite"][f"{s}/{n}"] = unrolled(cfg.replace(n_layers=n), shape)
out["decode"] = {}
for t in DECODE_T:
    shape = dataclasses.replace(SHAPES["decode_32k"], seq_len=t,
                                global_batch=8)
    out["decode"][str(t)] = unrolled(cfg, shape)
json.dump(out, open(os.path.join(out_dir, "ref_depth.json"), "w"))
"""

# The reference's records' counts for granite_8b's pod cells. Importing
# repro.launch.dryrun sets 512 host devices, so this runs on its own.
REF_POD = """
import json, os, sys
from repro.launch import dryrun as dr
from repro.configs import SHAPES, get_config
from repro.launch.mesh import make_production_mesh

mesh = make_production_mesh(multi_pod=False)
cfg = get_config("granite_8b")
out = {name: dr._cost_points(cfg, SHAPES[name], mesh)
       for name in ("train_4k", "decode_32k")}
json.dump(out, open(os.path.join(sys.argv[1], "ref_pod.json"), "w"))
"""


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The synthetic lines on disk, and the two JAX reference scripts
    started at once (``ref`` and ``ref_pod`` wait for them)."""
    d = tmp_path_factory.mktemp("dryrun")
    (d / "lines.json").write_text(json.dumps([x[0] for x in _hlo_lines()]))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    consts = (f"DECODE_T = {DECODE_T!r}\nGRANITE_SEQ = {GRANITE_SEQ!r}\n"
              f"GRANITE_LAYERS = {GRANITE_LAYERS!r}\n")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", script, str(d)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, script in (("ref", textwrap.dedent(REF)),
                             ("ref_depth", consts + textwrap.dedent(REF_DEPTH)),
                             ("ref_pod", textwrap.dedent(REF_POD)))}
    try:
        yield d, procs
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.communicate()


def _finished(work, name):
    d, procs = work
    proc = procs[name]
    try:
        out, err = proc.communicate(timeout=JOB_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, f"stdout:\n{out}\nstderr:\n{err}"
    return json.loads((d / f"{name}.json").read_text())


@pytest.fixture(scope="module")
def ref(work):
    return _finished(work, "ref")


@pytest.fixture(scope="module")
def ref_depth(work):
    return _finished(work, "ref_depth")


@pytest.fixture(scope="module")
def ref_pod(work):
    return _finished(work, "ref_pod")


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


def test_decode_cell_keeps_the_cache_where_it_is(ref_depth, fake8):
    # granite SMOKE's decode on (4, 2): the cache's time axis over "model"
    # stays there (split-T: only q's heads and the softmax partials move),
    # so the collective bytes do not grow with the cache; at each length
    # they stay at or under the reference's depth-exact count, and no
    # higher than before the train step's plan was made explicit.
    cfg = get_config("granite_8b", smoke=True)
    got = {}
    for t in DECODE_T:
        shape = dataclasses.replace(SHAPES["decode_32k"], seq_len=t,
                                    global_batch=8)
        dev = dr.analyze_cell(dr._prep_cfg(cfg, shape), shape,
                              fake8)["per_device"]
        got[t] = dev["collective_wire_bytes"]
        want = ref_depth["decode"][str(t)]["total"]
        assert 0 < got[t] <= min(want, SPLIT_T_DECODE_BYTES), (t, got[t],
                                                               want)
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
# granite_8b's decode cells with split-T, before the train step's plan was
# made explicit (the same analyze_cell): SMOKE on fake8 at both cache
# lengths, decode_32k on the pod mesh. The decode step keeps DTensor's plan
# for its few rows (``sharding.zero_gather_pays``); neither may rise.
SPLIT_T_DECODE_BYTES = 90_432.0
SPLIT_T_POD_DECODE_BYTES = 350_350_800.0
# granite_8b train_4k's predicted peak bytes a device on the pod mesh before
# the plan was explicit (remat "full"): the peak may not rise.
PARENT_POD_TRAIN_PEAK = 34_785_352_724


def test_train_cell_loses_the_logits_gather(fake8):
    # The loss keeps the logits' vocab sharded: the all-gather of a rank's
    # [2, 128, 512] f32 logits from vocab slices of 256 over "model" goes.
    # Its backward was free (DTensor slices the gathered gradient back to
    # the shards), and stays so. By site: three all-reduces of a [2, 128]
    # f32 partial over "model" (the max, the sum of exp, the label's
    # logit) are all the loss moves beside the mean's scalars, and no site
    # moves as many bytes as one gather of the logits.
    cfg = get_config("granite_8b", smoke=True)
    dev = dr.analyze_cell(cfg, CELL, fake8, sites=True)["per_device"]
    sites = dev["collective_by_site"]
    data, p = 4, 2                                  # the (4, 2) mesh
    rows = CELL.global_batch // data * CELL.seq_len
    gather = dr.wire_bytes("all-gather", rows * cfg.vocab_size * 4, p)
    backward = 0
    partials = 3 * dr.wire_bytes("all-reduce", rows * 4, p)
    assert gather == 262_144
    assert sum(GATHERED_LOSS_BYTES.values()) \
        - dev["collective_wire_bytes"] >= gather + backward
    loss = {k: v for k, v in sites.items()
            if k.split(" ")[0] in ("models/lm.py:lm_loss",
                                   "models/layers.py:log_likelihood",
                                   "models/layers.py:vocab_partial",
                                   "models/layers.py:combine_vocab_partials")}
    assert loss.pop("models/layers.py:combine_vocab_partials forward") \
        == partials
    assert set(loss) <= {"models/lm.py:lm_loss forward"}, loss
    assert sum(loss.values()) < 64                  # f32 scalars
    assert max(sites.values()) < gather, sites


@pytest.fixture(scope="module")
def smoke_counts():
    """Every family's SMOKE train cell's collective wire bytes a device on
    (4, 2) (``dryrun.smoke_train_counts``: the CELL on a fake group of 8)."""
    assert dr.SMOKE_CELL == ("train_4k", CELL.seq_len, CELL.global_batch)
    return dr.smoke_train_counts()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_cell_within_the_reference(ref_depth, smoke_counts, arch):
    # Every family's SMOKE train cell on (4, 2) moves at most the
    # reference's collective bytes a device, counted depth-exact.
    got = smoke_counts[arch]
    want = ref_depth["train"][arch]["total"]
    assert 0 < got <= want, (got, want)


def test_chip_smoke_holds_these_smoke_counts(smoke_counts):
    # chip_smoke.py holds the card host's torch release to this table of
    # torch 2.13's counts: every block's plan is explicit, so a release
    # counts the same, and a change to a plan must refresh the table.
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(SRC).parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    table = cs.DRYRUN_SMOKE_WIRE_213
    assert set(table) == set(smoke_counts)
    for arch, want in table.items():
        assert abs(smoke_counts[arch] - want) <= cs.DRYRUN_SMOKE_REL * want, (
            arch, smoke_counts[arch], want)


def _granite_layer_bytes(cfg, rows: int) -> dict:
    """The collective wire bytes a device of one granite block on the
    (4, 2) mesh, reckoned from shapes, by site and phase, for ``rows`` rows
    (batch x sequence) a rank. ``data`` = 4 shards the batch and every
    weight's d_model, ``model`` = 2 the residual's d_model, d_ff and the
    heads; every activation moves in bf16, the norms' statistics in f32."""
    data, model, bf16, f32 = 4, 2, 2, 4
    w = dr.wire_bytes
    d, f = cfg.d_model, cfg.d_ff
    hd, h, kv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    block = w("all-gather", rows * d * bf16, model)       # input gathered
    out = w("reduce-scatter", rows * d // model * bf16, model)
    # the MLP: gate, up and down, d_ff cut over model, each gathered over
    # data forward and its gradient reduce-scattered over data backward
    mlp_w = 3 * d * f // model * bf16
    mlp = {"forward": block + w("all-gather", mlp_w, data) + out,
           "backward": block + w("reduce-scatter", mlp_w // data, data) + out,
           # the recompute stops before the down product's reduce-scatter
           "recompute": block + w("all-gather", mlp_w, data)}
    # attention: wq and wo a rank's heads, wk and wv whole (the rules
    # replicate the kv heads over model; a rank projects those its q heads
    # read), each gathered over data; wk's and wv's gradients then summed
    # over model too
    q_w = d * h // model * hd * bf16
    kv_w = d * kv * hd * bf16
    gathered = w("all-gather", 2 * q_w + 2 * kv_w, data)
    attn = {"forward": block + gathered + out,
            "recompute": block + gathered + out,
            "backward": block + out
            + w("reduce-scatter", (2 * q_w + 2 * kv_w) // data, data)
            + w("all-reduce", 2 * kv_w // data, model)}
    # each RMSNorm: the [rows, 1] f32 sum of squares all-reduced over
    # model, forward and backward; the scale's gradient gathered over
    # model and summed over data
    stat = w("all-reduce", rows * f32, model)
    scale = w("all-gather", d * f32, model) + w("all-reduce", d * f32, data)
    norm = {"forward": stat, "recompute": stat, "backward": stat + scale}
    return {"models/layers.py:_mlp_sharded": mlp,
            "models/attention.py:_attention_sharded": attn,
            "models/layers.py:_norm_sharded": norm}


def _embed_bytes(cfg, rows: int) -> dict:
    """The embedding's collective wire bytes a device on the (4, 2) mesh,
    reckoned from shapes, by phase: the table ([V, D], vocab over model,
    d_model over data) cast to bf16 and its data shard gathered, the vocab
    partials of the rank's ``rows`` tokens reduce-scattered into the
    residual layout; backward the duals, the table's gradient
    reduce-scattered over data in bf16."""
    data, model, bf16 = 4, 2, 2
    w = dr.wire_bytes
    v, d = cfg.vocab_size, cfg.d_model
    return {"forward": w("all-gather", v // model * d * bf16, data)
            + w("reduce-scatter", rows * d // model * bf16, model),
            "backward": w("all-gather", rows * d * bf16, model)
            + w("reduce-scatter", v // model * d // data * bf16, data)}


def _moe_layer_bytes(cfg, rows: int) -> dict:
    """One MoE block's collective wire bytes a device on the (4, 2) mesh,
    reckoned from shapes, by phase: the bf16 block input gathered over
    model; each rank's E / 2 experts' three weights and the router gathered
    over data (their gradients reduce-scattered there, the router's then
    summed over model: every rank of a row routes it); the f32 [2, E / 2]
    means of the rank's experts all-reduced over data and the f32 aux
    scalar over model; the partial output reduce-scattered into the
    residual layout (the recompute stops short of it). The buffers
    [B, E, C, D] never move."""
    data, model, bf16, f32 = 4, 2, 2, 4
    w = dr.wire_bytes
    mc, d = cfg.moe, cfg.d_model
    e_loc = mc.n_experts // model
    block = w("all-gather", rows * d * bf16, model)
    out = w("reduce-scatter", rows * d // model * bf16, model)
    experts = 3 * e_loc * d * mc.d_ff * bf16
    router = d * mc.n_experts * bf16
    forward = (block + w("all-gather", experts + router, data)
               + w("all-reduce", 2 * e_loc * f32, data)
               + w("all-reduce", f32, model))
    return {"forward": forward + out, "recompute": forward,
            "backward": block + out
            + w("reduce-scatter", (experts + router) // data, data)
            + w("all-reduce", router // data, model)}


def _mamba2_layer_bytes(cfg, rows: int) -> dict:
    """One Mamba-2 block's collective wire bytes a device on the (4, 2)
    mesh, reckoned from shapes, by phase: the bf16 block input gathered
    over model; w_in gathered whole over all 8 ranks (its columns do not
    follow the heads) and w_out's data shard, in bf16, their gradients
    reduce-scattered back; the gated norm's f32 [rows, 1] sum of squares
    all-reduced over model, forward and backward; the partial output
    reduce-scattered into the residual layout (the recompute stops short
    of it); the replicated parameters' f32 gradients (conv, dt_bias, A_log,
    D, the norm's scale) summed over both mesh dims."""
    data, model, bf16, f32 = 4, 2, 2, 4
    w = dr.wire_bytes
    s, d = cfg.ssm, cfg.d_model
    d_inner = s.expand * d
    h = d_inner // s.head_dim
    w_in = d * (2 * d_inner + 2 * s.state_dim + h) * bf16
    w_out = d_inner // model * d * bf16
    small = (s.conv_kernel * (d_inner + 2 * s.state_dim) + 3 * h
             + d_inner) * f32
    block = w("all-gather", rows * d * bf16, model)
    out = w("reduce-scatter", rows * d // model * bf16, model)
    stat = w("all-reduce", rows * f32, model)
    forward = (block + w("all-gather", w_in, data * model)
               + w("all-gather", w_out, data) + stat)
    return {"forward": forward + out, "recompute": forward,
            "backward": block + out + stat
            + w("reduce-scatter", w_in // (data * model), data * model)
            + w("reduce-scatter", w_out // data, data)
            + w("all-reduce", small, model) + w("all-reduce", small, data)}


def _pop_sites(sites: dict, counts: dict, reckoned: dict) -> None:
    """Take each ``site`` ``phase``'s bytes out of ``sites``, each equal to
    ``counts[site][phase]`` times ``reckoned[site][phase]``."""
    for site, phases in counts.items():
        for phase, k in phases.items():
            assert sites.pop(f"{site} {phase}") == k * reckoned[site][phase], (
                site, phase)


def test_mlp_and_norm_sites_reckoned_from_shapes(fake8):
    # granite SMOKE's cell by site: the MLP's and the norms' collectives are
    # exactly the bf16 block-input gathers, the output reduce-scatters, the
    # weights' data gathers and gradient reduce-scatters, and the f32
    # [B, S, 1] statistics' all-reduces. No other site of the MLP or the
    # norm moves anything: the [B, S, d_ff] hidden and the f32 activations
    # stay where they are. The embedding moves its bf16 table's gather and
    # the partials' reduce-scatter, and their duals.
    cfg = get_config("granite_8b", smoke=True)
    sites = dr.analyze_cell(cfg, CELL, fake8,
                            sites=True)["per_device"]["collective_by_site"]
    rows = CELL.global_batch // 4 * CELL.seq_len
    layer = _granite_layer_bytes(cfg, rows)
    layer["models/layers.py:embed"] = _embed_bytes(cfg, rows)
    n = cfg.n_layers
    counts = {"models/layers.py:_mlp_sharded": dict.fromkeys(
                  ("forward", "backward", "recompute"), n),
              # two norms a block, and the final norm outside any block
              "models/layers.py:_norm_sharded": {
                  "forward": 2 * n + 1, "backward": 2 * n + 1,
                  "recompute": 2 * n},
              "models/layers.py:embed": {"forward": 1, "backward": 1}}
    _pop_sites(sites, counts, layer)
    assert not [k for k in sites if k.startswith((
        "models/layers.py:mlp", "models/layers.py:_act",
        "models/layers.py:_mlp", "models/layers.py:norm",
        "models/layers.py:_norm", "models/layers.py:_row_mean",
        "models/layers.py:embed"))], sites


BLOCK_SITES = {"arctic_480b": ("models/moe.py", "_moe_sharded",
                               _moe_layer_bytes),
               "llama4_maverick_400b_a17b": ("models/moe.py", "_moe_sharded",
                                             _moe_layer_bytes),
               "zamba2_1p2b": ("models/mamba2.py", "_mamba2_sharded",
                               _mamba2_layer_bytes)}


@pytest.mark.parametrize("arch", list(BLOCK_SITES))
def test_moe_mamba2_and_embed_sites_reckoned_from_shapes(fake8, arch):
    # The MoE (arctic's top-2 with a dense residual, llama4's top-1 with a
    # shared expert) and Mamba-2 (zamba2) on their explicit plans: each
    # block's site moves exactly the bytes reckoned from shapes, by phase,
    # the embedding's table moves in bf16, and no other site of the block's
    # module or of the embedding moves anything (the MoE's expert buffers,
    # Mamba-2's activations and every f32 activation stay where they are).
    cfg = get_config(arch, smoke=True)
    sites = dr.analyze_cell(cfg, CELL, fake8,
                            sites=True)["per_device"]["collective_by_site"]
    rows = CELL.global_batch // 4 * CELL.seq_len
    module, fn, reckon = BLOCK_SITES[arch]
    site, n = f"{module}:{fn}", cfg.n_layers
    _pop_sites(sites, {site: dict.fromkeys(("forward", "backward",
                                            "recompute"), n),
                       "models/layers.py:embed": {"forward": 1,
                                                  "backward": 1}},
               {site: reckon(cfg, rows),
                "models/layers.py:embed": _embed_bytes(cfg, rows)})
    assert not [k for k in sites if k.startswith((
        f"{module}:", "models/layers.py:embed"))], sites


def _dtensor_op_sites(cfg, mesh, monkeypatch) -> list:
    """The innermost port frame (``module:function``) of every aten op that
    receives a DTensor in one train step of ``cfg`` on ``mesh``, and the
    op; the dry-run's meter sees them before DTensor does."""
    from torch.distributed.tensor import DTensor

    seen, plain = [], dr._Meter.__torch_dispatch__

    def spy(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            f, site = sys._getframe(1), None
            while f is not None and site is None:
                path = f.f_code.co_filename
                if "/repro_torch/" in path:
                    site = (f"{path.rpartition('/repro_torch/')[2]}:"
                            f"{f.f_code.co_name}")
                f = f.f_back
            seen.append((site, str(func)))
        return plain(self, func, types, args, kwargs)

    monkeypatch.setattr(dr._Meter, "__torch_dispatch__", spy)
    dr.analyze_cell(cfg, CELL, mesh)
    return seen


@pytest.mark.parametrize("arch", list(BLOCK_SITES))
def test_no_dtensor_op_in_the_explicit_blocks(fake8, monkeypatch, arch):
    # On a multi-rank mesh no aten op under the embedding, the MoE or
    # Mamba-2 reaches DTensor's dispatch (whose plans change between torch
    # releases): they run on local tensors between the ``local_part`` /
    # ``from_local_parts`` boundaries, whose redistributions are the only
    # DTensor work. Other blocks' casts still reach it, which shows the
    # spy sees such ops.
    seen = _dtensor_op_sites(get_config(arch, smoke=True), fake8,
                             monkeypatch)
    watched = ("models/moe.py:", "models/mamba2.py:",
               "models/layers.py:embed", "sharding.py:embed_sharded",
               "sharding.py:cast_local")
    assert not [x for x in seen if x[0] and x[0].startswith(watched)], seen
    assert seen


@pytest.mark.parametrize("seq", GRANITE_SEQ)
def test_granite_depth_within_the_reference(ref_depth, fake8, seq):
    # granite SMOKE at 2 and 3 layers: each depth at or under the
    # reference's depth-exact count, and the third layer's extra bytes (a
    # block's) at or under the reference's; a block moves what its MLP,
    # attention and two norms do, reckoned from shapes.
    cfg = get_config("granite_8b", smoke=True)
    shape = dataclasses.replace(CELL, seq_len=seq)
    got = {n: dr.analyze_cell(cfg.replace(n_layers=n), shape, fake8)[
        "per_device"]["collective_wire_bytes"] for n in GRANITE_LAYERS}
    want = {n: ref_depth["granite"][f"{seq}/{n}"]["total"]
            for n in GRANITE_LAYERS}
    for n in GRANITE_LAYERS:
        assert 0 < got[n] <= want[n], (n, got[n], want[n])
    lo, hi = GRANITE_LAYERS
    per_layer = got[hi] - got[lo]
    assert 0 < per_layer <= want[hi] - want[lo]
    layer = _granite_layer_bytes(cfg, 8 // 4 * seq)
    norms = 2 * sum(layer.pop("models/layers.py:_norm_sharded").values())
    assert per_layer == norms + sum(sum(v.values()) for v in layer.values())


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
            rec = dr.analyze_cell(dr._prep_cfg(cfg, shape), shape, mesh)
            out[name] = dict(rec["per_device"],
                             peak_bytes_est=rec["memory"]["peak_bytes_est"])
    return out


def test_pod_cells_within_the_reference(pod_cells, ref_pod):
    # granite_8b on the 16 x 16 pod mesh against the reference's records
    # (``_cost_points``: depth-exact). Train moves at most the reference's
    # collective bytes a device; its predicted peak stays under what it was
    # before the plan was explicit; decode does not rise.
    train, decode = pod_cells["train_4k"], pod_cells["decode_32k"]
    assert 0 < train["collective_wire_bytes"] \
        <= ref_pod["train_4k"]["coll"], train["collective_wire_bytes"]
    assert 0 < train["peak_bytes_est"] <= PARENT_POD_TRAIN_PEAK
    assert 0 < decode["collective_wire_bytes"] \
        <= min(SPLIT_T_POD_DECODE_BYTES, ref_pod["decode_32k"]["coll"])


def test_kv_projection_duplication_costs_less_than_its_all_reduces(
        pod_cells, ref_pod):
    # granite_8b on the pod: each rank's 2 q heads read one of the 8 kv
    # heads, so each kv head is projected on 2 of the 16 model ranks. Those
    # FLOPs are what lifts the cell above the reference's (less them it is
    # under), and at the data-sheet rates they cost less time than the
    # partial k and v all-reduces they replace. At SMOKE on (4, 2) nothing
    # is duplicated (a rank's 2 q heads read its own kv head).
    pod = dr.kv_plan_costs(get_config("granite_8b"), SHAPES["train_4k"],
                           (16, 16))
    flops = pod_cells["train_4k"]["hlo_flops"]
    assert flops - pod["duplicated"]["flops"] <= ref_pod["train_4k"][
        "flops"] < flops
    assert 0 < pod["duplicated"]["s"] < pod["all_reduced"]["s"], pod
    smoke = dr.kv_plan_costs(get_config("granite_8b", smoke=True), CELL,
                             (4, 2))
    assert smoke["duplicated"]["flops"] == 0 < smoke["all_reduced"]["bytes"]


def test_mamba2_w_in_gathered_where_that_moves_fewer_bytes():
    # w_in's contiguous model cut does not follow the heads: gathering it
    # whole (what ``_mamba2_sharded`` does, and what
    # ``_mamba2_layer_bytes`` reckons) moves fewer bytes than moving the
    # projected columns into the heads' layout, at SMOKE on (4, 2) and in
    # zamba2's pod cells, where a rank holds 65,536 rows.
    smoke = dr.mamba2_w_in_costs(get_config("zamba2_1p2b", smoke=True),
                                 CELL, (4, 2))
    assert smoke == {"gather": 33_152, "move": 55_168}
    full = get_config("zamba2_1p2b")
    for name in ("train_4k", "prefill_32k"):
        pod = dr.mamba2_w_in_costs(full, SHAPES[name], (16, 16))
        assert pod["gather"] < pod["move"] / 2, (name, pod)


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


def _mesh3_job():
    """Every family's sharded train step on the multipod mesh's axes,
    ("pod", "data", "model") = (2, 2, 2): the batch over two mesh dims."""
    from repro_torch import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_train_state, make_train_step
    from repro_torch.optim import OptConfig

    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    rng = np.random.default_rng(0)
    oc = OptConfig(warmup_steps=1, total_steps=10)
    out = {}
    for arch in FAMILIES:
        cfg = get_config(arch, smoke=True).replace(compute_dtype="float32")
        model = build_model(cfg, "cpu")
        batch = _batch(cfg, rng, 8, 16)
        state = make_train_state(model, torch.Generator().manual_seed(0))
        dstate = shd.distribute_state(state, mesh)
        plain, m1 = make_train_step(model, oc)(state, batch)
        sharded, m2 = make_train_step(model, oc, mesh=mesh)(dstate, batch)
        full = shd.full_state(sharded)["params"]
        out[arch] = {"loss": (float(m1["loss"]), float(m2["loss"])),
                     "param_err": max(
                         float((p.detach() - full.get_parameter(n)).abs().max())
                         for n, p in plain["params"].named_parameters())}
    return out if dist.get_rank() == 0 else None


@pytest.fixture(scope="module")
def mesh3_job(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh3_job")
    return spawn(_mesh3_job, 8, timeout_s=JOB_TIMEOUT_S, store_dir=str(d))[0]


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_family_trains_on_three_mesh_axes(mesh3_job, arch):
    """The explicit plan on the multipod mesh's axes: the batch's rows over
    "pod" and "data" together, so the weights' ZeRO gathers and their
    gradients' reduce-scatters run over "data" alone while the gradients
    sum over both. The same bars as on (4, 2)."""
    rec = mesh3_job[arch]
    l1, l2 = rec["loss"]
    assert abs(l1 - l2) < 1e-5, (l1, l2)
    assert rec["param_err"] < 1e-4


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


ONE_RANK_ARCHS = ("relic_tiny", "whisper_large_v3", "qwen3_14b",
                  "rwkv6_1p6b")
ONE_RANK_STEPS = 3


def _one_rank_job():
    """Each of ``ONE_RANK_ARCHS`` (SMOKE, its own dtypes): AdamW steps of
    the DTensor state on a (1, 1) mesh and of the plain state, from the
    same draw and batches; the largest parameter difference and both
    losses."""
    from repro_torch import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_train_state, make_train_step
    from repro_torch.optim import OptConfig

    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    oc = OptConfig(warmup_steps=1, total_steps=10)
    out = {}
    for arch in ONE_RANK_ARCHS:
        cfg = get_config(arch, smoke=True)
        model = build_model(cfg, "cpu")
        rng = np.random.default_rng(0)
        batches = [_batch(cfg, rng, 4, 16) for _ in range(ONE_RANK_STEPS)]
        plain = make_train_state(model, torch.Generator().manual_seed(0))
        dstate = shd.distribute_state(plain, mesh)
        losses = {"plain": [], "mesh": []}
        for batch in batches:
            plain, m1 = make_train_step(model, oc)(plain, batch)
            dstate, m2 = make_train_step(model, oc, mesh=mesh)(dstate, batch)
            losses["plain"].append(float(m1["loss"]))
            losses["mesh"].append(float(m2["loss"]))
        full = shd.full_state(dstate)["params"]
        out[arch] = {"losses": losses, "param_err": max(
            float((p.detach() - full.get_parameter(n)).abs().max())
            for n, p in plain["params"].named_parameters())}
    return out


@pytest.fixture(scope="module")
def one_rank_job(tmp_path_factory):
    d = tmp_path_factory.mktemp("one_rank_job")
    return spawn(_one_rank_job, 1, timeout_s=JOB_TIMEOUT_S,
                 store_dir=str(d))[0]


@pytest.mark.parametrize("arch", ONE_RANK_ARCHS)
def test_one_rank_mesh_trains_bit_for_bit(one_rank_job, arch):
    """On a mesh of one rank (the card's) every sharded path keeps the
    single device's arithmetic: the losses and the parameters after
    AdamW's first steps equal the plain step's exactly (AdamW turns a
    last-bit gradient change near 0 into a visible weight difference)."""
    rec = one_rank_job[arch]
    assert rec["losses"]["mesh"] == rec["losses"]["plain"]
    assert rec["param_err"] == 0.0


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
