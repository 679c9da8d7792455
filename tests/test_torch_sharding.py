"""The port's partition rules (``repro_torch.sharding``) held against the
JAX package's ``repro.sharding``, with no process group: the rule of every
parameter of every architecture, ``fit_spec`` over a grid of shapes and
meshes, the activation layouts, and the translation of a fitted spec into
DTensor placements.

The reference's ``fit_spec`` reads only a mesh's ``shape`` mapping and
``axis_names``, so a stand-in mesh needs no devices; the port's reads a
``DeviceMesh``'s ``mesh_dim_names`` and ``shape`` or the same stand-in.
"""

import itertools

import jax
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro import sharding as jshd
from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro_torch import sharding as shd
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import build_model

MESHES = [((8,), ("data",)), ((4, 2), ("data", "model")),
          ((2, 4, 2), ("pod", "data", "model")), ((8,), ("model",))]


class FakeMesh:
    """A mesh as the reference's ``fit_spec`` reads it."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


def _ref_leaves(arch):
    """{'/'-joined leaf path: reference entries} of the reference's
    parameters at SMOKE size (shapes only, nothing computed)."""
    model = jbuild_model(jget_config(arch, smoke=True))
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    specs = jshd.param_specs(tree)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {jshd._path_str(kp): tuple(spec) for kp, spec in flat}


def test_same_architectures():
    assert list(ARCH_IDS) == list(JARCH_IDS)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_entries_match_reference(arch):
    ref = _ref_leaves(arch)
    model = build_model(get_config(arch, smoke=True), "meta")
    params = model.init(torch.Generator().manual_seed(0))
    seen = set()
    for name, p in params.named_parameters():
        path, stacked = shd.reference_path(name)
        assert path in ref, (name, path)
        want = ref[path][1:] if stacked else ref[path]
        if stacked:
            assert ref[path][0] is None, (path, ref[path])
        assert shd.port_param_entries(name, p.ndim) == tuple(want), name
        seen.add(path)
    assert seen == set(ref)


_SHAPES = [(512, 64), (64, 512), (64, 4, 16), (4, 16, 64), (30, 7),
           (16, 160), (160, 16), (8, 64, 16, 32), (6,), (56, 128, 7168),
           (2, 48, 20)]
_ENTRIES = [("model", "data"), ("data", "model"), ("data", "model", None),
            ("model", None, "data"), (("pod", "data"), None),
            (None, ("pod", "data", "model")), ("data", None, "model"),
            ("model", "data", None, None), (), (None,), ("data",)]


@pytest.mark.parametrize("shape,axes", MESHES)
def test_fit_spec_matches_reference(shape, axes):
    mesh = FakeMesh(shape, axes)
    n = 0
    for dims, entries in itertools.product(_SHAPES, _ENTRIES):
        entries = tuple(entries) + (None,) * max(0, len(dims) - len(entries))
        want = tuple(jshd.fit_spec(mesh, entries, dims))
        assert shd.fit_spec(mesh, entries, dims) == want, (dims, entries)
        n += 1
    assert n == len(_SHAPES) * len(_ENTRIES)


@pytest.mark.parametrize("layout", ["tp", "replicated", "seq", "mixed"])
@pytest.mark.parametrize("kind", ["act", "resid", "blockin"])
def test_activation_layouts_match_reference(layout, kind):
    mesh = FakeMesh((2, 4, 2), ("pod", "data", "model"))
    shape = (8, 32, 64)
    logical = ("batch", None, "model")
    want = None
    jshd.set_activation_layout(layout)
    shd.set_activation_layout(layout)
    try:
        with jshd.use_sharding_rules(mesh):
            tokens = list(logical)
            if kind == "resid" and layout == "replicated":
                tokens = [tokens[0], None, None]
            elif kind == "resid" and layout == "seq":
                tokens = [tokens[0], "model", None]
            elif kind == "blockin":
                tokens = ([tokens[0], None, None] if layout == "mixed"
                          else None)
            if tokens is not None:
                want = tuple(jshd.fit_spec(
                    mesh, [jshd._resolve(t) for t in tokens], shape))
        with shd.use_sharding_rules(_DimNames(mesh)):
            got = shd.act_spec(_DimNames(mesh), shape, *logical, kind=kind)
    finally:
        jshd.set_activation_layout("tp")
        shd.set_activation_layout("tp")
    assert got == want


class _DimNames(FakeMesh):
    """The stand-in as a DeviceMesh names its axes."""

    def __init__(self, mesh):
        self.mesh_dim_names = mesh.axis_names
        self.shape = tuple(mesh.shape.values())


def test_placements_translation():
    mesh = _DimNames(FakeMesh((2, 4, 2), ("pod", "data", "model")))
    assert shd.placements(mesh, (None, None)) == (Replicate(),) * 3
    assert shd.placements(mesh, ("model", "data")) == (
        Replicate(), Shard(1), Shard(0))
    assert shd.placements(mesh, (("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    with pytest.raises(ValueError):
        shd.placements(mesh, (("data", "pod"),))
    # a parameter's placements: the rule of its stacked leaf, fitted
    m2 = _DimNames(FakeMesh((4, 2), ("data", "model")))
    assert shd.param_placements(m2, "layers.0.attn.wq", (64, 4, 16)) == (
        Shard(0), Shard(1))
    assert shd.param_placements(m2, "layers.1.attn.wq", (64, 3, 16)) == (
        Shard(0), Replicate())            # 3 heads do not divide model=2
    assert shd.param_placements(m2, "final_norm.scale", (64,)) == (
        Replicate(), Replicate())
    # a batch over ("pod", "data") where both divide it, else "data", else
    # replicated (the reference dry-run's _batch_axes)
    assert shd.placements(mesh, [shd.batch_axes(mesh, 16), None]) == (
        Shard(0), Shard(0), Replicate())
    assert shd.batch_axes(mesh, 4) == ("data",)
    assert shd.batch_axes(mesh, 3) is None


def test_shard_act_passes_plain_tensors():
    x = torch.ones(2, 3, 4)
    assert shd.shard_act(x, "batch", None, "model") is x
    with shd.use_sharding_rules(_DimNames(FakeMesh((4, 2),
                                                   ("data", "model")))):
        assert shd.shard_act(x, "batch", None, "model", kind="resid") is x
    assert shd.current_mesh() is None
