"""The port's training path (``repro_torch.optim``, ``launch.steps``'s train
step) held against the JAX package's ``repro.optim`` and
``repro.launch.steps`` on the same numpy inputs, with the reference's
weights and optimizer state carried across by ``models/convert.py``.

In float32 compute only the summation order differs between the two
frameworks, so gradients, losses and norms hold at 1e-4 relative. After an
AdamW step a parameter moves by lr * m / (sqrt(v) + eps): the bias-corrected
ratio is close to +-1 whatever the gradient's size, so where the two
gradients differ in their last bits the step differs by at most about
lr * |dg| / eps; the parameters and the moments are held at 1e-4 relative
plus 1e-6 absolute (lr is at most 3e-4 here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from repro import optim as joptim
from repro.configs import get_config as jget_config
from repro.launch.steps import make_train_state as jmake_train_state
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import build_model as jbuild_model
from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.launch.steps import make_train_state, make_train_step
from repro_torch.models import build_model
from repro_torch.models.convert import (named_to_numpy, params_from_numpy,
                                        train_state_from_numpy, train_state_to_numpy)

F32 = dict(param_dtype="float32", compute_dtype="float32")
RTOL, ATOL = 1e-4, 1e-6


def _cfgs(arch="relic_tiny", **kw):
    return (jget_config(arch, smoke=True).replace(**kw),
            get_config(arch, smoke=True).replace(**kw))


def _batch(cfg, rng, b=2, s=32):
    """The same batch for both packages: (jax dict, torch dict)."""
    tokens = rng.integers(0, cfg.vocab_size, (b, s))
    labels = rng.integers(0, cfg.vocab_size, (b, s))
    jb = {"tokens": jnp.asarray(tokens, jnp.int32),
          "labels": jnp.asarray(labels, jnp.int32),
          "mask": jnp.ones((b, s), jnp.float32)}
    tb = {"tokens": torch.as_tensor(tokens), "labels": torch.as_tensor(labels),
          "mask": torch.ones((b, s))}
    return jb, tb


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _assert_trees_close(got, want, rtol=RTOL, atol=ATOL):
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=str(path))


# ---------------------------------------------------------------------------
# optim
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 9, 10, 55, 100, 140])
def test_schedule_matches_jax(step):
    oc = optim.OptConfig(warmup_steps=10, total_steps=100)
    want = joptim.schedule(joptim.OptConfig(warmup_steps=10, total_steps=100),
                           jnp.asarray(step, jnp.int32))
    np.testing.assert_allclose(optim.schedule(oc, step), float(want), rtol=1e-6)


@pytest.mark.parametrize("warmup,total", [(0, 0), (1, 1)])
def test_schedule_guards_match_jax(warmup, total):
    for step in (0, 1, 5):
        want = joptim.schedule(joptim.OptConfig(warmup_steps=warmup,
                                                total_steps=total),
                               jnp.asarray(step, jnp.int32))
        got = optim.schedule(optim.OptConfig(warmup_steps=warmup,
                                             total_steps=total), step)
        np.testing.assert_allclose(got, float(want), rtol=1e-6)


def _small_tree(rng):
    """A small parameter tree: (jax dict, torch module) with equal values."""
    vals = {"w": rng.normal(size=(3, 4)), "norm": {"scale": np.ones(4)},
            "b": rng.normal(size=(5,))}
    jtree = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), vals)
    mod = nn.ModuleDict({
        "top": nn.ParameterDict({"w": nn.Parameter(torch.tensor(vals["w"], dtype=torch.float32)),
                                 "b": nn.Parameter(torch.tensor(vals["b"], dtype=torch.float32))}),
        "norm": nn.ParameterDict({"scale": nn.Parameter(torch.ones(4))}),
    })
    names = {"top.w": ("w",), "top.b": ("b",), "norm.scale": ("norm", "scale")}
    return jtree, mod, names


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree, np.float32)


@pytest.mark.parametrize("scale", [0.01, 10.0])   # below and above clip_norm
def test_clip_and_adamw_update_match_jax(rng, scale):
    jparams, tparams, names = _small_tree(rng)
    oc_kw = dict(warmup_steps=2, total_steps=10, weight_decay=0.1)
    joc, toc = joptim.OptConfig(**oc_kw), optim.OptConfig(**oc_kw)
    jopt = joptim.init_opt_state(jparams)
    topt = optim.init_opt_state(tparams)
    for step in range(3):
        graw = {name: rng.normal(size=tuple(tparams.get_parameter(name).shape))
                * scale for name in names}
        jgrads = jax.tree.map(lambda a: a, jparams)
        for name, path in names.items():
            node = jgrads
            for key in path[:-1]:
                node = node[key]
            node[path[-1]] = jnp.asarray(graw[name], jnp.float32)
        tgrads = {n: torch.tensor(g, dtype=torch.float32) for n, g in graw.items()}
        jclipped, jnorm = joptim.clip_by_global_norm(jgrads, toc.clip_norm)
        tclipped, tnorm = optim.clip_by_global_norm(tgrads, toc.clip_norm)
        np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
        for name, path in names.items():
            np.testing.assert_allclose(tclipped[name].numpy(), _leaf(jclipped, path),
                                       rtol=1e-6, atol=1e-7)
        jparams, jopt, jlr = joptim.adamw_update(joc, jclipped, jopt, jparams,
                                                 jnp.asarray(step, jnp.int32))
        _, topt, tlr = optim.adamw_update(toc, tclipped, topt, tparams, step)
        np.testing.assert_allclose(tlr, float(jlr), rtol=1e-6)
        for name, path in names.items():
            np.testing.assert_allclose(tparams.get_parameter(name).detach().numpy(),
                                       _leaf(jparams, path), rtol=1e-6, atol=1e-7)
            for k in ("mu", "nu"):
                np.testing.assert_allclose(topt[k][name].numpy(),
                                           _leaf(jopt[k], path), rtol=1e-5, atol=1e-9)


# ---------------------------------------------------------------------------
# gradients and train steps against the reference, f32
# ---------------------------------------------------------------------------

def test_lm_loss_gradients_match_jax(rng):
    jcfg, tcfg = _cfgs(**F32)
    jmodel, tmodel = jbuild_model(jcfg), build_model(tcfg, "cpu")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, _np_tree(jparams))
    jb, tb = _batch(tcfg, rng)
    (jloss, _), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(jparams, jb)
    tloss, _ = tmodel.loss(tparams, tb)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    got = named_to_numpy(tparams, {n: p.grad for n, p in tparams.named_parameters()})
    _assert_trees_close(got, _np_tree(jgrads), rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def jstate():
    """The reference's relic_tiny SMOKE train state (f32), made once."""
    jcfg, _ = _cfgs(**F32)
    return jmake_train_state(jbuild_model(jcfg), jax.random.PRNGKey(0))


def test_train_state_round_trip(jstate):
    _, tcfg = _cfgs(**F32)
    tree = _np_tree(jstate)
    state = train_state_from_numpy(tcfg, tree)
    assert state["step"] == 0 and set(state["opt"]) == {"mu", "nu"}
    assert set(state["opt"]["mu"]) == {n for n, _ in state["params"].named_parameters()}
    back = train_state_to_numpy(state)
    assert back["step"].dtype == np.int32
    _assert_trees_close(_np_tree(back), tree, rtol=0, atol=0)


def test_train_state_from_numpy_rejects_a_foreign_optimizer_tree(jstate):
    _, tcfg = _cfgs(**F32)
    tree = _np_tree(jstate)
    del tree["opt"]["nu"]["lm_head"]
    with pytest.raises(ValueError, match="optimizer nu tree mismatch.*lm_head"):
        train_state_from_numpy(tcfg, tree)
    tree = _np_tree(jstate)
    tree["opt"]["mu"]["embed"]["table"] = tree["opt"]["mu"]["embed"]["table"][:-1]
    with pytest.raises(ValueError, match="embed.table: shape"):
        train_state_from_numpy(tcfg, tree)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_step_matches_jax(rng, jstate, n_steps):
    jcfg, tcfg = _cfgs(**F32)
    oc_kw = dict(warmup_steps=2, total_steps=10)
    jstep = jax.jit(jmake_train_step(jbuild_model(jcfg), joptim.OptConfig(**oc_kw)))
    tstep = make_train_step(build_model(tcfg, "cpu"), optim.OptConfig(**oc_kw))
    js, ts = jstate, train_state_from_numpy(tcfg, _np_tree(jstate))
    for _ in range(n_steps):
        jb, tb = _batch(tcfg, rng)
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, tb)
        for key in ("loss", "ce", "grad_norm", "lr", "tokens"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-4,
                                       err_msg=key)
    assert ts["step"] == int(js["step"]) == n_steps
    got = train_state_to_numpy(ts)
    want = _np_tree(js)
    _assert_trees_close(got["params"], want["params"])
    _assert_trees_close(got["opt"]["mu"], want["opt"]["mu"])
    _assert_trees_close(got["opt"]["nu"], want["opt"]["nu"], atol=1e-9)


def test_grad_accum_matches_full_batch_and_jax(jstate):
    """grad_accum=4 against 1 on one batch of 8 (tests/test_properties.py:
    93-112 holds the reference to 2%; in f32 the port holds to 1e-4)."""
    jcfg, tcfg = _cfgs(**F32)
    _, tb = _batch(tcfg, np.random.default_rng(0), b=8)
    jb = {k: jnp.asarray(v.numpy()) for k, v in tb.items()}
    out = {}
    for ga in (1, 4):
        oc = optim.OptConfig(warmup_steps=2, total_steps=10, grad_accum=ga)
        ts = train_state_from_numpy(tcfg, _np_tree(jstate))
        ts, m = make_train_step(build_model(tcfg, "cpu"), oc)(ts, tb)
        out[ga] = (float(m["grad_norm"]), train_state_to_numpy(ts)["params"])
    np.testing.assert_allclose(out[4][0], out[1][0], rtol=1e-4)
    _assert_trees_close(out[4][1], out[1][1])
    joc = joptim.OptConfig(warmup_steps=2, total_steps=10, grad_accum=4)
    _, jm = jax.jit(jmake_train_step(jbuild_model(jcfg), joc))(jstate, jb)
    np.testing.assert_allclose(out[4][0], float(jm["grad_norm"]), rtol=1e-4)


def test_grad_accum_rejects_an_uneven_split():
    _, tcfg = _cfgs()
    model = build_model(tcfg, "cpu")
    state = make_train_state(model, torch.Generator().manual_seed(0))
    _, tb = _batch(tcfg, np.random.default_rng(0), b=6)
    step = make_train_step(model, optim.OptConfig(grad_accum=4))
    with pytest.raises(ValueError, match="microbatches"):
        step(state, tb)


# ---------------------------------------------------------------------------
# the port on its own: tests/test_models.py:38-57, tests/test_properties.py:68-90
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["relic_tiny", "rwkv6_1p6b", "zamba2_1p2b"])
def test_smoke_train_step(arch, rng):
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg, "cpu")
    state = make_train_state(model, torch.Generator().manual_seed(0))
    before = {n: p.detach().clone() for n, p in state["params"].named_parameters()}
    _, tb = _batch(cfg, rng)
    step = make_train_step(model, optim.OptConfig(warmup_steps=2, total_steps=10))
    state, metrics = step(state, tb)
    assert np.isfinite(float(metrics["loss"])), arch
    assert state["step"] == 1
    moved = max((p.detach() - before[n]).abs().max().item()
                for n, p in state["params"].named_parameters())
    assert moved > 0, arch
    _, metrics2 = step(state, tb)
    assert np.isfinite(float(metrics2["loss"])), arch


def test_training_reduces_loss():
    """The uncompressed half of tests/test_properties.py:68-90."""
    cfg = get_config("relic_tiny", smoke=True)
    model = build_model(cfg, "cpu")
    rng = np.random.default_rng(0)
    _, tb = _batch(cfg, rng, b=4)
    state = make_train_state(model, torch.Generator().manual_seed(0))
    step = make_train_step(model, optim.OptConfig(warmup_steps=2, total_steps=30))
    for _ in range(15):
        state, m = step(state, tb)
    assert float(m["loss"]) < 5.0, float(m["loss"])


def test_gradient_compression_is_not_ported():
    _, tcfg = _cfgs()
    model = build_model(tcfg, "cpu")
    oc = optim.OptConfig(compress_grads=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make_train_step(model, oc)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make_train_state(model, torch.Generator().manual_seed(0), oc)


@pytest.mark.parametrize("arch", ["relic_tiny", "rwkv6_1p6b", "zamba2_1p2b"])
def test_train_step_through_the_kernels_raises(arch, rng):
    """use_kernels=True reaches a kernel wrapper with parameters that need
    a gradient: the wrapper refuses rather than drop that gradient."""
    cfg = get_config(arch, smoke=True).replace(use_kernels=True)
    model = build_model(cfg, "cpu")
    state = make_train_state(model, torch.Generator().manual_seed(0))
    _, tb = _batch(cfg, rng)
    step = make_train_step(model, optim.OptConfig())
    with pytest.raises(RuntimeError, match="use_kernels=False"):
        step(state, tb)
