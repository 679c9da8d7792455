"""Rematerialisation (``cfg.remat``: "full" | "dots" | "none") in the port,
held against the JAX package on the CPU at SMOKE size in f32.

The reference wraps each block in ``jax.checkpoint`` at five sites
(``src/repro/models/lm.py`` block stack, Mamba blocks, shared attention;
``src/repro/models/encdec.py`` encoder, decoder); the port wraps the same
blocks in ``torch.utils.checkpoint`` (``models/layers.py::remat``). Remat
changes what the backward keeps, never a value: a train step under "full"
or "dots" equals the step without remat, and the reference's step under
the same policy. Under "full" autograd keeps only each block's inputs;
"dots" keeps besides the outputs of the 2-D products (``aten.mm``), which
its selective checkpoint caches outside autograd's saved tensors, so those
are read as the bytes still alive after the forward (the dry-run's meter).
Serving runs without grad, where every policy is the block itself: the
kernels' calls stay as they are.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as joptim
from repro.launch.steps import make_train_state as jmake_train_state
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import build_model as jbuild_model
from repro_torch import optim
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import ops
from repro_torch.launch import dryrun as dr
from repro_torch.launch import serve
from repro_torch.launch import steps as tsteps
from repro_torch.launch.steps import make_train_state, make_train_step
from repro_torch.models import attention as attn
from repro_torch.models import build_model, encdec, lm
from repro_torch.models import layers as L
from repro_torch.models.convert import (params_from_numpy, train_state_from_numpy,
                                        train_state_to_numpy)

F32 = dict(param_dtype="float32", compute_dtype="float32")
OC = dict(warmup_steps=2, total_steps=10)
F32_BYTES = 4


def _inputs(cfg, rng, b=2, s=16):
    """tokens, labels and mask, plus the family's frames or patches, as
    numpy arrays drawn from ``rng``."""
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


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _cfg(arch, policy, **kw):
    return get_config(arch, smoke=True).replace(**F32, remat=policy, **kw)


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="unknown remat policy"):
        lm._remat("some", lambda x: x)


# ---------------------------------------------------------------------------
# A train step under each policy: the same step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_step_equals_the_step_without_remat(rng, arch):
    """One AdamW step from the same state and batch under "none", "full" and
    "dots": metrics, parameters and both moments at 1e-6 relative (the
    recompute runs the same ops on the same inputs)."""
    batch = _torch_batch(_inputs(_cfg(arch, "none"), rng))
    out = {}
    for policy in ("none", "full", "dots"):
        model = build_model(_cfg(arch, policy), "cpu")
        state = make_train_state(model, torch.Generator().manual_seed(0))
        state, metrics = make_train_step(model, optim.OptConfig(**OC))(state, batch)
        out[policy] = (train_state_to_numpy(state), metrics)
    want, wm = out["none"]
    for policy in ("full", "dots"):
        got, gm = out[policy]
        for key in ("loss", "ce", "aux", "grad_norm"):
            np.testing.assert_allclose(float(gm[key]), float(wm[key]), rtol=1e-6,
                                       err_msg=f"{policy} {key}")
        for part in ("params", "opt"):
            for (path, a), b in zip(
                    jax.tree_util.tree_flatten_with_path(want[part])[0],
                    jax.tree.leaves(got[part])):
                np.testing.assert_allclose(b, a, rtol=1e-6, atol=0,
                                           err_msg=f"{policy} {path}")


# ---------------------------------------------------------------------------
# ... and the reference's step under the same policy
# ---------------------------------------------------------------------------

class _GradsModel:
    """A stand-in for the reference's ``Model`` in its train step: the loss
    sum(p * G) over the leaves, whose gradient is the batch's G exactly."""

    @staticmethod
    def loss(params, batch):
        total = sum(jnp.sum(p * g) for p, g in zip(jax.tree.leaves(params),
                                                   jax.tree.leaves(batch["grads"])))
        return total, {"loss": total}


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_step_matches_reference(rng, monkeypatch, arch, policy):
    """The port's step under ``policy`` against the reference's under the
    same policy (``jax.checkpoint``, or its dots policy), in the two holds
    of tests/test_torch_families.py: the loss metrics at 1e-4 and every
    gradient against ``jax.grad`` of the reference's loss; then the
    reference's jitted clip-and-AdamW step and the port's on the
    reference's gradients, parameters and moments at 1e-4 relative, 1e-6
    absolute. Each gradient leaf is held in norm, within 1e-4 of its own:
    f32 summation order, which scales with the summands, leaves a few
    embedding-row gradients that are sums of cancelling terms past 1e-6
    absolute and 1e-4 of their value in RWKV-6, Zamba2 and Llama-4, with
    or without remat (the reference's own jitted and eager gradients lie
    up to 3.6e-6 apart there)."""
    jcfg = jconfigs.get_config(arch, smoke=True).replace(**F32, remat=policy)
    tcfg = _cfg(arch, policy)
    jmodel = jbuild_model(jcfg)
    js = jmake_train_state(jmodel, jax.random.PRNGKey(0))
    ts = train_state_from_numpy(tcfg, jax.tree.map(np.asarray, js))
    batch = _inputs(tcfg, rng)
    (_, jmetrics), jg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        js["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    handed = {n: p.detach() for n, p in params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jg)).named_parameters()}
    own_grads = tsteps._grads

    def reference_grads(model, params, b):
        metrics, grads = own_grads(model, params, b)
        for name, g in grads.items():
            want = handed[name].numpy()
            err = np.linalg.norm(g.numpy() - want)
            assert err <= 1e-4 * np.linalg.norm(want) + 1e-6, (name, err)
        return metrics, handed

    monkeypatch.setattr(tsteps, "_grads", reference_grads)
    js, jm = jax.jit(jmake_train_step(_GradsModel, joptim.OptConfig(**OC)))(
        js, {"grads": jg})
    ts, tm = make_train_step(build_model(tcfg, "cpu"), optim.OptConfig(**OC))(
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
# What the backward keeps
# ---------------------------------------------------------------------------

SAVED_ARCHS = ["relic_tiny", "whisper_large_v3", "zamba2_1p2b"]
B, S = 2, 16


def _block_inputs(cfg) -> int:
    """Bytes of every checkpointed call's tensor inputs: each block's input
    [B, S, D] (Zamba2's shared block once a group too); the decoder's
    blocks take the encoder's output [B, T, D] besides, one tensor."""
    row = B * cfg.d_model * F32_BYTES
    if cfg.family == "encdec":
        t = cfg.frontend.n_tokens
        return row * (cfg.enc_layers * t + cfg.n_layers * S + t)
    if cfg.family == "hybrid":
        return row * S * (cfg.n_layers + lm._hybrid_groups(cfg)[0])
    return row * S * cfg.n_layers


def _attn_products(p, rows_q, rows_kv) -> int:
    """Output elements of an attention layer's four projections."""
    _, h, hd = p["wq"].shape
    kv = p["wk"].shape[1]
    return rows_q * h * hd + 2 * rows_kv * kv * hd + rows_q * p["wo"].shape[2]


def _mlp_products(p, rows) -> int:
    return rows * sum(p[n].shape[1] for n in ("w_up", "w_gate", "w_down")
                      if n in p)


def _dense_products(p, rows) -> int:
    return _attn_products(p["attn"], rows, rows) + _mlp_products(p["mlp"], rows)


def _two_d_products(cfg, params) -> int:
    """Bytes of the outputs of the blocks' 2-D products, from the weights'
    shapes: every projection of attention, the MLP and the Mamba block."""
    rows = B * S
    if cfg.family == "encdec":
        t = B * cfg.frontend.n_tokens
        n = sum(_dense_products(lp, t) for lp in params["enc_layers"])
        for lp in params["dec_layers"]:
            n += _attn_products(lp["self_attn"], rows, rows)
            n += _attn_products(lp["cross_attn"], rows, t)
            n += _mlp_products(lp["mlp"], rows)
    elif cfg.family == "hybrid":
        n = sum(rows * (lp["ssm"]["w_in"].shape[1] + lp["ssm"]["w_out"].shape[1])
                for lp in params["layers"])
        n += lm._hybrid_groups(cfg)[0] * _dense_products(params["shared_attn"], rows)
    else:
        n = sum(_dense_products(lp, rows) for lp in params["layers"])
    return n * F32_BYTES


def _kept(cfg, monkeypatch, rng):
    """(bytes autograd saved for the checkpointed calls, bytes of tensors made
    by the forward and alive after it) of one SMOKE loss forward. The first
    is read through ``saved_tensors_hooks`` while a block call runs (each
    remat site counts its calls), by storage; the second by the dry-run's
    meter (weakref finalizers on every storage the forward makes)."""
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = _torch_batch(_inputs(cfg, rng, B, S))
    inside, saved = [0], {}
    plain_remat = L.remat

    def counted(policy, fn):
        inner = plain_remat(policy, fn)

        def call(*args, **kwargs):
            inside[0] += 1
            try:
                return inner(*args, **kwargs)
            finally:
                inside[0] -= 1
        return call

    def pack(t):
        if inside[0]:
            st = t.untyped_storage()
            saved[st.data_ptr()] = st.nbytes()
        return t

    monkeypatch.setattr(lm, "_remat", counted)
    monkeypatch.setattr(encdec, "_remat", counted)
    meter = dr._Meter()
    with meter, torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = model.loss(params, batch)
    live = meter.live
    loss.backward()      # the saved tensors are all used
    return sum(saved.values()), live, params


@pytest.mark.parametrize("arch", SAVED_ARCHS)
def test_full_keeps_block_inputs_and_dots_the_2d_products(monkeypatch, arch):
    got = {policy: _kept(_cfg(arch, policy), monkeypatch, np.random.default_rng(0))
           for policy in ("none", "full", "dots")}
    cfg, params = _cfg(arch, "full"), got["full"][2]
    # "full": autograd holds exactly the blocks' inputs
    assert got["full"][0] == _block_inputs(cfg), got
    # "dots": the same saved tensors, and alive besides them the outputs of
    # the 2-D products (the selective checkpoint's cache)
    assert got["dots"][0] == got["full"][0]
    assert got["dots"][1] - got["full"][1] == _two_d_products(cfg, params)
    # "none": every block's activations
    assert got["none"][0] > got["dots"][0]
    assert got["none"][1] > got["dots"][1] > got["full"][1]


# ---------------------------------------------------------------------------
# Serving: no grad, so the kernels' calls stay as they are
# ---------------------------------------------------------------------------

SERVED = {"relic_tiny": {"flash_attention_bhsd"},
          "rwkv6_1p6b": {"wkv6_bhtk"},
          "zamba2_1p2b": {"ssd_bhtp", "flash_attention_bhsd"},
          "whisper_large_v3": {"flash_attention_bhsd"}}


@pytest.mark.parametrize("arch", sorted(SERVED))
def test_serve_and_forward_calls_under_full_remat(monkeypatch, arch):
    """``serve.run`` (encode, prefill, decode on the scheduler) and the
    teacher-forced forward with ``use_kernels=True`` under "full" against
    "none": the same tokens and logits, and every kernel wrapper called as
    often (on the card each call is a launch)."""
    calls = {}
    for name in ("flash_attention_bhsd", "wkv6_bhtk", "ssd_bhtp"):
        def counting(*a, _fn=getattr(ops, name), _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, name, counting)
    args = serve.parse_args(["--arch", arch, "--smoke", "--batch", "2",
                             "--prompt-len", "4", "--gen", "4", "--device", "cpu"])
    out = {}
    for policy in ("none", "full"):
        cfg = get_config(arch, smoke=True).replace(
            param_dtype="bfloat16", use_kernels=True, remat=policy)
        model = build_model(cfg, "cpu")
        params = model.init(torch.Generator().manual_seed(0))
        calls.clear()
        toks, _ = serve.run(args, cfg, model, params, torch.device("cpu"))
        served = dict(calls)
        calls.clear()
        extra = (serve.make_frames(cfg, 2, 4, "cpu"),) \
            if cfg.family == "encdec" else ()
        with torch.no_grad():
            logits, _ = model.forward(params, toks, *extra)
        out[policy] = (toks, logits, served, dict(calls))
    (t0, l0, s0, f0), (t1, l1, s1, f1) = out["none"], out["full"]
    assert torch.equal(t0, t1) and torch.equal(l0, l1)
    assert s1 == s0 and f1 == f0, (s0, s1, f0, f1)
    assert set(f1) == SERVED[arch] and all(f1.values()), f1


def test_attention_projections_are_2d_products():
    """The projections reach ``aten.mm`` (what "dots" keeps), not the batch-1
    ``aten.bmm`` that ``torch.einsum("bsd,dhk->bshk")`` takes; attention's
    own products carry batch dimensions (``aten.bmm``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func)
            return func(*args, **(kwargs or {}))

    cfg = _cfg("relic_tiny", "dots")
    p = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    x = torch.randn(B, S, cfg.d_model)
    with Ops():
        attn.self_attention(cfg, p["layers"][0]["attn"], x)
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert seen.count(mm) == 4 and seen.count(bmm) == 2, seen
