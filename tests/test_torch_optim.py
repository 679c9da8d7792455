"""The port's gradient compression (``repro_torch.optim.compression``) and
Adafactor (``repro_torch.optim.adafactor``) held against the JAX package's
``repro.optim`` on the same numpy inputs, and the reference's own property
tests (tests/test_substrates.py:145-225) run over the port.

Compression's int8 codes and scales are held equal to the reference's, bit
for bit (the same division, round half to even and clip). Adafactor's
updates are held at 1e-6 over three steps; its state size equals the
reference's count. A ``compress_grads=True`` train step is held against the
reference's step on the same gradients: the port's own gradients are held
against the reference's at 1e-4 relative plus 1e-6 absolute (as
tests/test_torch_train.py holds them), then both steps run on the
reference's, the port's handed them in place of its own and the
reference's through a stand-in model whose loss has exactly that gradient.
The compressed gradients are then the same bits on both sides, so every
leaf's residual is held equal bit for bit after every step, and the
parameters and moments, which differ only by the global norm's summation
order, at the tolerance of tests/test_torch_train.py's update test (1e-6 /
1e-7, moments 1e-5 / 1e-9). The reference's step runs op by op here: under
``jax.jit`` XLA turns the scale's division by 127 into a product with
1/127, which moves the scale's last bit, and the port follows the
reference's code, not that rewrite.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import optim as joptim
from repro.configs import get_config as jget_config
from repro.launch.steps import make_train_state as jmake_train_state
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import build_model as jbuild_model
from repro.optim import compression as jcomp
from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.launch import steps as tsteps
from repro_torch.launch.steps import make_train_state, make_train_step
from repro_torch.models import build_model
from repro_torch.models.convert import (named_to_numpy, params_from_numpy,
                                        train_state_from_numpy, train_state_to_numpy)
from repro_torch.optim import compression as comp
from repro_torch.optim.stacks import leaves

F32 = dict(param_dtype="float32", compute_dtype="float32")
ADAFACTOR_TOL = 1e-6


def _cfgs(arch="relic_tiny", **kw):
    return (jget_config(arch, smoke=True).replace(**kw),
            get_config(arch, smoke=True).replace(**kw))


def _batch(cfg, rng, b=2, s=32):
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


def _assert_trees_close(got, want, rtol, atol):
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=str(path))


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 255, 256, 257, 1000, 4096])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 30.0])
def test_quantize_codes_and_scales_equal_reference(rng, n, scale):
    x = (rng.normal(size=(n,)) * scale).astype(np.float32)
    x[::7] = 0.0
    q, s, size = comp.quantize(torch.from_numpy(x))
    jq, js, jsize = jcomp.quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and size == jsize == n
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        comp.dequantize(q, s, size, x.shape).numpy(),
        np.asarray(jcomp.dequantize(jq, js, jsize, x.shape)))


def test_quantize_rounds_half_to_even_and_handles_zero_blocks():
    """Levels exactly halfway between two codes go to the even one, as
    ``jnp.round`` does; an all-zero block has scale 0 and codes 0."""
    x = np.zeros((512,), np.float32)
    x[:6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]   # scale 1: levels as given
    q, s, _ = comp.quantize(torch.from_numpy(x))
    jq, js, _ = jcomp.quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q[0, :6].tolist() == [127, 0, 2, 2, 0, -2]
    assert s[1, 0].item() == 0.0 and not q[1].any()


@given(st.integers(0, 2**32 - 1), st.integers(1, 4096))
@settings(deadline=None, max_examples=30)
def test_quantize_error_bound(seed, n):
    """tests/test_substrates.py:145-158 on the port."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=(n,)) * rng.uniform(0.1, 10)).astype(np.float32))
    q, s, size = comp.quantize(x)
    back = comp.dequantize(q, s, size, x.shape)
    blocks = np.pad(x.numpy(), (0, (-n) % 256)).reshape(-1, 256)
    step = np.abs(blocks).max(1) / 127.0
    err = np.abs(back.numpy() - x.numpy())
    err_blocks = np.pad(err, (0, (-n) % 256)).reshape(-1, 256)
    assert (err_blocks.max(1) <= step / 2 + 1e-7).all()


def test_error_feedback_preserves_signal():
    """tests/test_substrates.py:161-174 on the port."""
    rng = np.random.default_rng(0)
    grads = {"w": torch.from_numpy(rng.normal(size=(128,)).astype(np.float32))}
    res = {"w": torch.zeros(128)}
    total_c = torch.zeros(128)
    steps = 50
    for _ in range(steps):
        c, res = comp.compress_with_feedback(grads, res)
        total_c = total_c + c["w"]
    err = float((total_c + res["w"] - grads["w"] * steps).abs().max())
    assert err < 1e-3, err


def test_compress_with_feedback_equals_reference_on_a_model_tree(rng):
    """On relic_tiny SMOKE's gradient tree with a residual: the layer stacks
    quantize as the reference's stacked leaves (blocks of 256 across layer
    boundaries), so the compressed gradients equal the reference's bit for
    bit and the residuals too."""
    jcfg, tcfg = _cfgs(**F32)
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, _np_tree(jparams))
    grads = {n: torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
             for n, p in tparams.named_parameters()}
    residual = {n: torch.from_numpy((rng.normal(size=p.shape) * 1e-3).astype(np.float32))
                for n, p in tparams.named_parameters()}
    jg = jax.tree.map(jnp.asarray, named_to_numpy(tparams, grads))
    jr = jax.tree.map(jnp.asarray, named_to_numpy(tparams, residual))
    want_g, want_r = jcomp.compress_with_feedback(jg, jr)
    got_g, got_r = comp.compress_with_feedback(grads, residual)
    for got, want in ((got_g, want_g), (got_r, want_r)):
        got = named_to_numpy(tparams, got)
        for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                jax.tree.leaves(got)):
            np.testing.assert_array_equal(b, np.asarray(a), err_msg=str(path))


def test_leaves_group_layer_stacks_in_layer_order():
    names = ["embed.table", "layers.1.attn.wq", "layers.0.attn.wq", "pos_embed",
             "enc_layers.0.mlp.w_up", "layers.10.attn.wq", "layers.2.attn.wq"]
    got = leaves(names)
    assert got[0] == ("embed.table", False, ["embed.table"])
    assert got[1] == ("layers.attn.wq", True,
                      ["layers.0.attn.wq", "layers.1.attn.wq", "layers.2.attn.wq",
                       "layers.10.attn.wq"])
    assert ("enc_layers.mlp.w_up", True, ["enc_layers.0.mlp.w_up"]) in got
    assert len(got) == 4


def test_optimizers_do_not_import_the_models():
    """The optimizers need the reference's leaf grouping only
    (``optim.stacks``), not the model or conversion layers."""
    code = ("import sys, repro_torch.optim, repro_torch.optim.compression\n"
            "bad = sorted(m for m in sys.modules if m.startswith("
            "'repro_torch.models'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).parents[1] / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_compressed_train_state_converts_both_ways():
    """make_train_state adds the residual (f32 zeros by parameter name) and
    convert carries it both ways, as the reference's state holds
    opt.residual."""
    jcfg, tcfg = _cfgs(**F32)
    oc = optim.OptConfig(compress_grads=True)
    state = make_train_state(build_model(tcfg, "cpu"),
                             torch.Generator().manual_seed(0), oc)
    assert set(state["opt"]) == {"mu", "nu", "residual"}
    for name, p in state["params"].named_parameters():
        r = state["opt"]["residual"][name]
        assert r.shape == p.shape and r.dtype == torch.float32 and not r.any()
    jstate = jmake_train_state(jbuild_model(jcfg), jax.random.PRNGKey(0),
                               joptim.OptConfig(compress_grads=True))
    tree = _np_tree(jstate)
    back = train_state_to_numpy(train_state_from_numpy(tcfg, tree))
    _assert_trees_close(back, tree, 0, 0)


class _GradsModel:
    """A stand-in for the reference's ``Model`` in its train step: the loss
    sum(p * G) over the leaves, whose gradient is the batch's G exactly."""

    @staticmethod
    def loss(params, batch):
        total = sum(jnp.sum(p * g) for p, g in zip(jax.tree.leaves(params),
                                                   jax.tree.leaves(batch["grads"])))
        return total, {"loss": total}


@pytest.mark.parametrize("arch,n_steps", [("relic_tiny", 1), ("relic_tiny", 3),
                                          ("arctic_480b", 2)])
def test_compressed_train_step_matches_jax(rng, monkeypatch, arch, n_steps):
    jcfg, tcfg = _cfgs(arch, **F32)
    oc_kw = dict(warmup_steps=2, total_steps=10, compress_grads=True)
    jmodel = jbuild_model(jcfg)
    jstate = jmake_train_state(jmodel, jax.random.PRNGKey(0),
                               joptim.OptConfig(**oc_kw))
    jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))
    jstep = jmake_train_step(_GradsModel, joptim.OptConfig(**oc_kw))   # op by op
    own_grads, handed = tsteps._grads, []

    def reference_grads(model, params, batch):
        metrics, grads = own_grads(model, params, batch)
        for name, g in grads.items():
            np.testing.assert_allclose(g.numpy(), handed[-1][name].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=name)
        return metrics, handed[-1]

    monkeypatch.setattr(tsteps, "_grads", reference_grads)
    tstep = make_train_step(build_model(tcfg, "cpu"), optim.OptConfig(**oc_kw))
    js, ts = jstate, train_state_from_numpy(tcfg, _np_tree(jstate))
    for t in range(n_steps):
        jb, tb = _batch(tcfg, rng)
        (_, jmetrics), jg = jgrads(js["params"], jb)
        handed.append({n: p.detach() for n, p in
                       params_from_numpy(tcfg, _np_tree(jg)).named_parameters()})
        js, jm = jstep(js, {"grads": jg})
        ts, tm = tstep(ts, tb)
        for key in ("loss", "ce", "tokens"):
            np.testing.assert_allclose(float(tm[key]), float(jmetrics[key]),
                                       rtol=1e-4, err_msg=key)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6,
                                       err_msg=key)
        got, want = train_state_to_numpy(ts), _np_tree(js)
        for (path, a), b in zip(
                jax.tree_util.tree_flatten_with_path(want["opt"]["residual"])[0],
                jax.tree.leaves(got["opt"]["residual"])):
            np.testing.assert_array_equal(b, a, err_msg=f"step {t} residual {path}")
        _assert_trees_close(got["params"], want["params"], 1e-6, 1e-7)
        for kind in ("mu", "nu"):
            _assert_trees_close(got["opt"][kind], want["opt"][kind], 1e-5, 1e-9)
    assert float(np.abs(jax.tree.leaves(got["opt"]["residual"])[0]).max()) > 0


def test_compressed_training_reduces_loss():
    """The compressed half of tests/test_properties.py:68-90 on the port."""
    cfg = get_config("relic_tiny", smoke=True)
    model = build_model(cfg, "cpu")
    _, tb = _batch(cfg, np.random.default_rng(0), b=4)
    oc = optim.OptConfig(warmup_steps=2, total_steps=30, compress_grads=True)
    state = make_train_state(model, torch.Generator().manual_seed(0), oc)
    step = make_train_step(model, oc)
    for _ in range(15):
        state, m = step(state, tb)
    assert float(m["loss"]) < 5.0, float(m["loss"])
    assert all(torch.isfinite(r).all() for r in state["opt"]["residual"].values())


# ---------------------------------------------------------------------------
# Adafactor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["relic_tiny", "arctic_480b"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adafactor_updates_match_reference(rng, arch, weight_decay):
    """Three steps from the same parameters with the same gradients:
    parameters and factored state at 1e-6 (the layer stacks as the
    reference's stacked leaves: a stacked norm scale [L, D] is factored,
    and the RMS clip sees the whole leaf)."""
    jcfg, tcfg = _cfgs(arch, **F32)
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, _np_tree(jparams))
    ac_kw = dict(weight_decay=weight_decay)
    jac, tac = joptim.AdafactorConfig(**ac_kw), optim.AdafactorConfig(**ac_kw)
    jstate, tstate = joptim.init_adafactor_state(jparams), optim.init_adafactor_state(tparams)
    oc = joptim.OptConfig(peak_lr=1e-2, warmup_steps=2, total_steps=40)
    for i in range(3):
        grads = {n: torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
                 for n, p in tparams.named_parameters()}
        jg = jax.tree.map(jnp.asarray, named_to_numpy(tparams, grads))
        lr = optim.schedule(optim.OptConfig(peak_lr=1e-2, warmup_steps=2,
                                            total_steps=40), i)
        jparams, jstate = joptim.adafactor_update(jac, jg, jstate, jparams,
                                                  jnp.int32(i), joptim.schedule(oc, jnp.int32(i)))
        tparams, tstate = optim.adafactor_update(tac, grads, tstate, tparams, i, lr)
    _assert_trees_close(named_to_numpy(tparams, dict(tparams.named_parameters())),
                        _np_tree(jparams), ADAFACTOR_TOL, ADAFACTOR_TOL)
    want_v = {".".join(str(k.key) for k in path): np.asarray(a)
              for path, a in jax.tree_util.tree_flatten_with_path(jstate["v"])[0]}
    got_v = {f"{key}.{kind}": t.numpy() for key, v in tstate["v"].items()
             for kind, t in v.items()}
    assert set(got_v) == set(want_v)
    for key, want in want_v.items():
        np.testing.assert_allclose(got_v[key], want, rtol=ADAFACTOR_TOL,
                                   atol=ADAFACTOR_TOL, err_msg=key)


@pytest.mark.parametrize("arch", ["relic_tiny", "whisper_large_v3", "arctic_480b"])
def test_state_bytes_equal_reference(arch):
    jcfg, tcfg = _cfgs(arch, **F32)
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, _np_tree(jparams))
    for adam in (True, False):
        assert (optim.state_bytes(tparams, adam=adam)
                == joptim.state_bytes(jparams, adam=adam)), adam


def test_adafactor_trains_and_saves_memory():
    """tests/test_substrates.py:178-222 on the port."""
    cfg = get_config("relic_tiny", smoke=True)
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    _, batch = _batch(cfg, np.random.default_rng(0), b=4)
    ac = optim.AdafactorConfig()
    oc = optim.OptConfig(peak_lr=1e-2, warmup_steps=2, total_steps=40)
    opt = optim.init_adafactor_state(params)
    l0 = None
    for i in range(20):
        params.zero_grad(set_to_none=True)
        loss, _ = model.loss(params, batch)
        loss.backward()
        grads = {n: p.grad for n, p in params.named_parameters()}
        grads, _ = optim.clip_by_global_norm(grads, 1.0)
        params, opt = optim.adafactor_update(ac, grads, opt, params, i,
                                             optim.schedule(oc, i))
        l0 = l0 if l0 is not None else float(loss.detach())
    assert float(loss.detach()) < l0 - 0.5, (l0, float(loss.detach()))
    adam_b = optim.state_bytes(params, adam=True)
    af_b = optim.state_bytes(params, adam=False)
    assert af_b < adam_b / 20, (adam_b, af_b)
