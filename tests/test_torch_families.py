"""Every architecture of the JAX package's ``ARCH_IDS`` on the port, at SMOKE
size: the dense configs, the MoE, the VLM's prefix path, the recurrent
families and the encoder-decoder, held against the JAX package on the same
numpy inputs with the reference's parameters carried across by
``repro_torch.models.convert``.

In float32 (parameters and compute) only the summation order differs, so
logits and losses hold at 1e-4, with ``use_kernels`` both ways (the JAX
side through its interpret-mode Pallas kernels, as tests/test_kernels.py
runs them; the port's wrappers take their plain versions for CPU tensors).
Decode against teacher forcing is held at the reference's own bar
(tests/test_models.py:117-123): 0.15 on logits and greedy agreement above
0.9. MoE routing tables are held equal, the aux loss at 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.steps import make_train_state as jmake_train_state
from repro.models import build_model as jbuild_model
from repro.models import encdec as jed
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch import optim
from repro_torch.launch.steps import make_train_state, make_train_step
from repro_torch.models import build_model
from repro_torch.models import moe
from repro_torch.models.convert import params_from_numpy, params_to_numpy

F32_TOL = 1e-4
BF16_TOL = 0.15
AUX_TOL = 1e-6
F32 = dict(param_dtype="float32", compute_dtype="float32")
ARCHS = list(jconfigs.ARCH_IDS)
# The families this slice ports (the others' own files cover them in depth).
NEW_ARCHS = ["whisper_large_v3", "llama4_maverick_400b_a17b", "arctic_480b",
             "granite_8b", "phi3_mini_3p8b", "llama3_405b", "qwen3_14b",
             "paligemma_3b"]


def _cfgs(arch, **kw):
    return (jconfigs.get_config(arch, smoke=True).replace(**kw),
            configs.get_config(arch, smoke=True).replace(**kw))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _agree(got, want):
    return (np.argmax(_np(got), -1) == np.argmax(_np(want), -1)).mean()


@pytest.fixture(scope="module")
def jparams():
    """Each arch's reference SMOKE parameters (float32), made on first use."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg, _ = _cfgs(arch, **F32)
            cache[arch] = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
        return cache[arch]
    return get


def _port(tcfg, tree):
    return params_from_numpy(tcfg, jax.tree.map(np.asarray, tree))


def _inputs(cfg, rng, b=2, s=16):
    """tokens, labels and mask, plus the family's extra input (frames
    [B,T,D] for the encoder-decoder, patches [B,N,E] for the VLM), as numpy
    float32 / int arrays drawn from ``rng``."""
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)),
           "mask": (rng.random((b, s)) > 0.25).astype(np.float32)}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(
            size=(b, cfg.frontend.n_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.normal(
            size=(b, cfg.frontend.n_tokens, cfg.frontend.embed_dim)
        ).astype(np.float32)
    return out


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _jax_forward(cfg, params, batch):
    toks = jnp.asarray(batch["tokens"])
    if cfg.family == "encdec":
        return jed.decode_train(cfg, params, toks,
                                jed.encode(cfg, params, jnp.asarray(batch["frames"])))
    extra = batch.get("patches")
    logits, _ = jlm.lm_forward(
        cfg, params, toks,
        extra_embed=None if extra is None else jnp.asarray(extra),
        prefix_len=None if extra is None else extra.shape[1])
    return logits


def _torch_extra(cfg, batch):
    key = {"encdec": "frames", "vlm": "patches"}.get(cfg.family)
    return (torch.from_numpy(batch[key]),) if key else ()


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_arch_ids_and_configs_match_reference():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert sorted(configs.all_configs()) == sorted(jconfigs.all_configs())
    for arch in ARCHS:
        for smoke in (False, True):
            got = dataclasses.asdict(configs.get_config(arch, smoke))
            want = dataclasses.asdict(jconfigs.get_config(arch, smoke))
            assert got == want, (arch, smoke)
    assert configs.canonical("arctic-480b") == "arctic_480b"


def test_unknown_arch_raises_as_in_the_reference():
    """An unknown name raises what the reference's ``get_config`` raises,
    and every family builds on the CPU."""
    for get_config in (jconfigs.get_config, configs.get_config):
        with pytest.raises(ModuleNotFoundError):
            get_config("no_such_arch")
    families = set()
    for arch in ARCHS:
        cfg = configs.get_config(arch, smoke=True)
        params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
        assert sum(p.numel() for p in params.parameters()) > 0
        families.add(cfg.family)
    assert families == {"dense", "moe", "vlm", "ssm", "hybrid", "encdec"}


# ---------------------------------------------------------------------------
# forward and loss against the reference, every arch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference_f32(rng, jparams, arch, use_kernels):
    jcfg, tcfg = _cfgs(arch, use_kernels=use_kernels, **F32)
    jp = jparams(arch)
    tp = _port(tcfg, jp)
    batch = _inputs(tcfg, rng)
    want = _jax_forward(jcfg, jp, batch)
    with torch.no_grad():
        got, aux = build_model(tcfg, "cpu").forward(
            tp, torch.from_numpy(batch["tokens"]), *_torch_extra(tcfg, batch))
    n_extra = tcfg.frontend.n_tokens if tcfg.family == "vlm" else 0
    assert got.shape == (2, 16 + n_extra, tcfg.vocab_size)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference_f32(rng, jparams, arch):
    jcfg, tcfg = _cfgs(arch, **F32)
    jp = jparams(arch)
    batch = _inputs(tcfg, rng)
    want, wm = jbuild_model(jcfg).loss(jp, _jax_batch(batch))
    with torch.no_grad():
        got, gm = build_model(tcfg, "cpu").loss(_port(tcfg, jp),
                                                _torch_batch(batch))
    _close(got, want, F32_TOL)
    _close(gm["ce"], wm["ce"], F32_TOL)
    np.testing.assert_allclose(float(gm["aux"]), float(wm["aux"]), rtol=AUX_TOL,
                               atol=AUX_TOL)
    assert float(gm["tokens"]) == float(wm["tokens"])
    if tcfg.family == "moe":
        assert float(gm["aux"]) > 0


def test_vlm_prefix_is_bidirectional(rng, jparams):
    """The patches see each other both ways (the prefix-LM mask): changing
    the last patch moves the first patch's logits. Without patches the
    VLM runs as a text model over the tokens alone."""
    _, tcfg = _cfgs("paligemma_3b", **F32)
    tp = _port(tcfg, jparams("paligemma_3b"))
    batch = _inputs(tcfg, rng)
    model = build_model(tcfg, "cpu")
    toks = torch.from_numpy(batch["tokens"])
    patches = torch.from_numpy(batch["patches"])
    with torch.no_grad():
        a, _ = model.forward(tp, toks, patches)
        patches2 = patches.clone()
        patches2[:, -1] += 1.0
        b, _ = model.forward(tp, toks, patches2)
        plain, _ = model.forward(tp, toks)
    assert not torch.allclose(a[:, 0], b[:, 0])
    assert plain.shape == (2, 16, tcfg.vocab_size)


# ---------------------------------------------------------------------------
# training (tests/test_models.py:38-57 over the port)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_smoke_train_step(arch, rng):
    cfg = configs.get_config(arch, smoke=True)
    model = build_model(cfg, "cpu")
    state = make_train_state(model, torch.Generator().manual_seed(0))
    before = {n: p.detach().clone() for n, p in state["params"].named_parameters()}
    batch = _torch_batch(_inputs(cfg, rng, s=32))
    batch["mask"] = torch.ones_like(batch["mask"])
    if "frames" in batch:
        batch["frames"] = batch["frames"].to(torch.bfloat16)
    if "patches" in batch:
        batch["patches"] = batch["patches"].to(torch.bfloat16)
    step = make_train_step(model, optim.OptConfig(warmup_steps=2, total_steps=10))
    state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"])), arch
    assert state["step"] == 1
    moved = max((p.detach() - before[n]).abs().max().item()
                for n, p in state["params"].named_parameters())
    assert moved > 0, arch
    _, metrics2 = step(state, batch)
    assert np.isfinite(float(metrics2["loss"])), arch


class _GradsModel:
    """A stand-in for the reference's ``Model`` in its train step: the loss
    sum(p * G) over the leaves, whose gradient is the batch's G exactly, so
    the jitted step runs its clip and AdamW on gradients it is handed."""

    @staticmethod
    def loss(params, batch):
        total = sum(jnp.sum(p * g) for p, g in zip(jax.tree.leaves(params),
                                                   jax.tree.leaves(batch["grads"])))
        return total, {"loss": total}


@pytest.mark.parametrize("arch", ["arctic_480b", "paligemma_3b", "whisper_large_v3"])
def test_train_step_matches_reference_f32(rng, monkeypatch, arch):
    """One AdamW step of the MoE, the VLM and the encoder-decoder against the
    reference from the same state and batch, in two holds (as
    test_torch_train.py splits them): the loss metrics and every gradient of
    the port's step against ``jax.grad`` of the reference's loss; then the
    reference's jitted clip-and-AdamW step and the port's on the same
    gradients (the reference's, handed to both), parameters and moments at
    1e-4 relative, 1e-6 absolute. AdamW's first step moves a weight by
    about lr * g / (|g| + 1e-8), so held end to end it would turn the f32
    summation order of a gradient near 1e-7 into a parameter difference
    above the bar."""
    from repro import optim as joptim
    from repro.launch.steps import make_train_step as jmake_train_step
    from repro_torch.launch import steps as tsteps
    from repro_torch.models.convert import train_state_from_numpy, train_state_to_numpy

    jcfg, tcfg = _cfgs(arch, **F32)
    jmodel = jbuild_model(jcfg)
    js = jmake_train_state(jmodel, jax.random.PRNGKey(0))
    ts = train_state_from_numpy(tcfg, jax.tree.map(np.asarray, js))
    batch = _inputs(tcfg, rng)
    oc = dict(warmup_steps=2, total_steps=10)
    (_, jmetrics), jg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        js["params"], _jax_batch(batch))
    handed = {n: p.detach() for n, p in
              _port(tcfg, jg).named_parameters()}
    own_grads = tsteps._grads

    def reference_grads(model, params, b):
        metrics, grads = own_grads(model, params, b)
        for name, g in grads.items():
            np.testing.assert_allclose(g.numpy(), handed[name].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=name)
        return metrics, handed

    monkeypatch.setattr(tsteps, "_grads", reference_grads)
    js, jm = jax.jit(jmake_train_step(_GradsModel, joptim.OptConfig(**oc)))(
        js, {"grads": jg})
    ts, tm = make_train_step(build_model(tcfg, "cpu"), optim.OptConfig(**oc))(
        ts, _torch_batch(batch))
    for key in ("loss", "ce"):
        np.testing.assert_allclose(float(tm[key]), float(jmetrics[key]),
                                   rtol=1e-4, err_msg=key)
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-4,
                                   err_msg=key)
    got, want = train_state_to_numpy(ts), jax.tree.map(np.asarray, js)
    for part in ("params", "opt"):
        for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(want[part])[0],
                                jax.tree.leaves(got[part])):
            np.testing.assert_allclose(b, np.asarray(a, np.float32), rtol=1e-4,
                                       atol=1e-6, err_msg=str(path))


# ---------------------------------------------------------------------------
# decode against teacher forcing (tests/test_models.py:88-123)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite_8b", "qwen3_14b",
                                  "llama4_maverick_400b_a17b"])
def test_decode_matches_teacher_forcing(arch, rng, jparams):
    """The port's one-token decode over a forced stream against its own
    teacher-forced forward in bf16 compute (the reference's bar), and
    against the reference's decode step in f32 (1e-4). The MoE runs
    drop-free, as the reference's test does: capacity at decode differs
    from a long forward once a row overflows."""
    def cfgs(**kw):
        jcfg, tcfg = _cfgs(arch, **kw)
        if tcfg.moe is not None:
            jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                        capacity_factor=16.0))
            tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe,
                                                        capacity_factor=16.0))
        return jcfg, tcfg

    b, s = 2, 16
    toks = rng.integers(0, 512, (b, s))
    jp = jparams(arch)
    for kw, tol in ((F32, F32_TOL), ({}, BF16_TOL)):
        jcfg, tcfg = cfgs(**kw)
        tp = _port(tcfg, jp)
        tmodel = build_model(tcfg, "cpu")
        cache = tmodel.init_cache(b, s)
        got = []
        with torch.no_grad():
            for t in range(s):
                logits, cache = tmodel.decode_step(
                    tp, cache, torch.from_numpy(toks[:, t:t + 1]), t)
                got.append(logits[:, 0])
            forced, _ = tmodel.forward(tp, torch.from_numpy(toks))
        got = torch.stack(got, dim=1)
        _close(got, forced, tol)
        assert _agree(got, forced) > 0.9, (arch, kw)
        if kw:
            jmodel = jbuild_model(jcfg)
            jcache, want = jmodel.init_cache(b, s), []
            jstep = jax.jit(jmodel.decode_step)
            for t in range(s):
                lj, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                                   jnp.int32(t))
                want.append(np.asarray(lj[:, 0]))
            _close(got, np.stack(want, axis=1), F32_TOL)


# ---------------------------------------------------------------------------
# MoE routing (models/moe.py)
# ---------------------------------------------------------------------------

def _route_both(mc, logits, cap):
    want = jmoe.route(mc, jnp.asarray(logits), cap)
    got = moe.route(mc, torch.from_numpy(logits), cap)
    return got, want


@pytest.mark.parametrize("arch", ["arctic_480b", "llama4_maverick_400b_a17b"])
@pytest.mark.parametrize("s", [1, 16, 64])
def test_route_matches_reference(rng, arch, s):
    mc = configs.get_config(arch, smoke=True).moe
    logits = rng.normal(size=(2, s, mc.n_experts)).astype(np.float32)
    cap = moe._capacity(mc, s)
    assert cap == jmoe._capacity(mc, s)
    (e, p, slot, keep, aux), (je, jp, jslot, jkeep, jaux) = _route_both(mc, logits, cap)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    _close(p, jp, AUX_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_TOL, atol=AUX_TOL)


@pytest.mark.parametrize("top_k", [1, 2])
def test_route_breaks_ties_as_the_reference(rng, top_k):
    """Equal gates (equal logits; bf16 router logits over 128 experts make
    them real): the lower expert index comes first, so the choices, their
    order and every slot equal the reference's."""
    mc = configs.MoEConfig(n_experts=8, top_k=top_k, d_ff=16)
    levels = np.array([0.0, 0.5, 1.0], np.float32)
    logits = levels[rng.integers(0, 3, size=(2, 32, 8))]
    logits[0, 0] = 1.0           # every gate tied
    logits[1, 3, [2, 6]] = 5.0   # a tie for the first choice
    cap = 4                      # overflow, so slot order decides keep
    (e, _, slot, keep, aux), (je, _, jslot, jkeep, jaux) = _route_both(mc, logits, cap)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    assert e[0, 0].tolist() == list(range(top_k))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert not keep.all()
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_TOL, atol=AUX_TOL)


def test_moe_routing_respects_capacity(rng):
    """tests/test_models.py:152-172 on the port."""
    mc = configs.get_config("arctic_480b", smoke=True).moe
    logits = torch.from_numpy(rng.normal(size=(2, 64, mc.n_experts)).astype(np.float32))
    cap = moe._capacity(mc, 64)
    eidx, probs, slot, keep, aux = moe.route(mc, logits, cap)
    assert bool((slot[keep] < cap).all())
    assert float(aux) > 0
    for b in range(2):
        pairs = set()
        for t in range(64):
            for j in range(mc.top_k):
                if keep[b, t, j]:
                    pair = (int(eidx[b, t, j]), int(slot[b, t, j]))
                    assert pair not in pairs
                    pairs.add(pair)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_moe_ffn_matches_reference(rng, jparams, capacity_factor):
    """The whole layer, dispatch table, expert products and combine, with
    and without dropped choices, f32 at 1e-4."""
    jcfg, tcfg = _cfgs("arctic_480b", **F32)
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                capacity_factor=capacity_factor))
    tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe,
                                                capacity_factor=capacity_factor))
    jp = jax.tree.map(lambda a: a[0], jparams("arctic_480b")["layers"]["moe"])
    tp = _port(tcfg, jparams("arctic_480b"))["layers"][0]["moe"]
    x = rng.normal(size=(2, 32, tcfg.d_model)).astype(np.float32)
    want, waux = jmoe.moe_ffn(jcfg, jp, jnp.asarray(x))
    with torch.no_grad():
        got, aux = moe.moe_ffn(tcfg, tp, torch.from_numpy(x))
    _close(got, want, F32_TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=AUX_TOL, atol=AUX_TOL)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_params_round_trip(arch, jparams):
    _, tcfg = _cfgs(arch, **F32)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams(arch))
    back = params_to_numpy(params_from_numpy(tcfg, tree))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_port_init_matches_reference_shapes_and_scales(arch, jparams):
    _, tcfg = _cfgs(arch, **F32)
    want = jax.tree.map(np.asarray, jparams(arch))
    got = params_to_numpy(build_model(tcfg, "cpu").init(
        torch.Generator().manual_seed(0)))
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        assert a.shape == b.shape, path
        # same distribution per leaf: ones, zeros, or normals of one scale
        np.testing.assert_allclose(b.std(), np.asarray(a, np.float32).std(),
                                   rtol=0.2, atol=1e-6, err_msg=str(path))
