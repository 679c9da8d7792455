"""Split-T decode attention and the vocab-parallel log-likelihood
(``repro_torch.models.attention.attention_partial`` /
``combine_partials``, ``repro_torch.models.layers.vocab_partial`` /
``combine_vocab_partials``) held against the unsplit functions and the JAX
package's on the same numpy inputs: the slices stacked on one device (the
default ``reduce``), then, in one job of two gloo ranks, the mesh paths that
reduce across ranks (``_split_t``, ``log_likelihood`` on a DTensor,
``sharding.argmax_sharded``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn
from repro_torch.configs import get_config
from repro_torch.launch.mesh import spawn
from repro_torch.models import attention as attn
from repro_torch.models import layers as L

# tests/test_kernels.py:70-71, the attention bars (chip_smoke.TOL)
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# archs whose decode reads an attention cache (self, cross or shared)
ARCHS = ["granite_8b", "qwen3_14b", "arctic_480b", "paligemma_3b",
         "whisper_large_v3", "zamba2_1p2b"]


def _qkv(rng, b, t, h, kv, d, dtype=torch.float32):
    arrs = [rng.normal(size=(b, 1, h, d)), rng.normal(size=(b, t, kv, d)),
            rng.normal(size=(b, t, kv, d))]
    arrs = [np.asarray(a, np.float32) for a in arrs]
    return arrs, [torch.as_tensor(a).to(dtype) for a in arrs]


def _split(q, k, v, cuts, kv_len):
    """combine_partials over attention_partial of each slice [a, b) of T."""
    edges = [0, *cuts, k.shape[1]]
    parts = [attn.attention_partial(q, k[:, a:b], v[:, a:b], t0=a,
                                    kv_len=kv_len)
             for a, b in zip(edges, edges[1:])]
    o, m, l = (torch.stack(x) for x in zip(*parts))
    return attn.combine_partials(o, m, l).to(q.dtype)


# T = 24 cut into 1 slice, 2 even, 3 uneven, 4 uneven; kv_len in the first
# slice, at a boundary, in the last, and the whole cache
CUTS = [(), (12,), (5, 13), (3, 8, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cuts", CUTS)
@pytest.mark.parametrize("kv_len", [1, 5, 12, 13, 24, None])
def test_partials_equal_attention_full(dtype, cuts, kv_len):
    rng = np.random.default_rng(len(cuts) * 100 + (kv_len or 0))
    _, (q, k, v) = _qkv(rng, 2, 24, 8, 2, 16, dtype)
    want = attn.attention_full(q, k, v, causal=False, kv_len=kv_len)
    got = _split(q, k, v, cuts, kv_len)
    assert got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n", [2, 4])
def test_partials_match_reference_at_smoke_sizes(arch, n):
    """Each arch's SMOKE heads over a 32-position cache cut into ``n``
    slices, against the JAX package's ``attention_full`` (no ``kv_len`` for
    Whisper's cross caches, which the decode reads whole)."""
    cfg = get_config(arch, smoke=True)
    kv_len = None if arch == "whisper_large_v3" else 19
    rng = np.random.default_rng(n)
    arrs, (q, k, v) = _qkv(rng, 2, 32, cfg.n_heads, cfg.n_kv_heads,
                           cfg.resolved_head_dim)
    step = 32 // n
    got = _split(q, k, v, range(step, 32, step), kv_len)
    want = ref_attn.attention_full(*map(jnp.asarray, arrs), causal=False,
                                   kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _vocab_split(logits, labels, n):
    """log_softmax(logits)[label] from ``n`` even vocab slices stacked."""
    b, s, v = logits.shape
    x = logits.reshape(b, s, n, v // n).permute(2, 0, 1, 3)
    v0 = (torch.arange(n) * (v // n))[:, None, None]
    return L.combine_vocab_partials(*L.vocab_partial(x, labels, v0))


@pytest.mark.parametrize("n", [2, 4])
def test_vocab_partials_match_reference_and_its_gradient(n):
    rng = np.random.default_rng(n)
    b, s, v = 2, 6, 512
    x_np = np.asarray(rng.normal(size=(b, s, v)) * 4, np.float32)
    lab_np = rng.integers(0, v, (b, s))
    lab_np[0, :n] = np.arange(n) * (v // n)          # each slice's first
    lab_np[1, :n] = np.arange(1, n + 1) * (v // n) - 1   # and last column
    w_np = np.asarray(rng.normal(size=(b, s)), np.float32)

    def ref_ll(x):
        logp = jax.nn.log_softmax(x, axis=-1)
        return jnp.take_along_axis(logp, jnp.asarray(lab_np)[..., None],
                                   axis=-1)[..., 0]

    want = ref_ll(jnp.asarray(x_np))
    want_g = jax.grad(lambda x: (ref_ll(x) * w_np).sum())(jnp.asarray(x_np))
    x = torch.tensor(x_np, requires_grad=True)
    got = _vocab_split(x, torch.as_tensor(lab_np), n)
    (got * torch.as_tensor(w_np)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-5)


def test_plain_log_likelihood_is_log_softmax_and_gather():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(2, 5, 64)), dtype=torch.float32)
    lab = torch.as_tensor(rng.integers(0, 64, (2, 5)))
    want = torch.gather(torch.log_softmax(x, dim=-1), -1, lab[..., None])
    assert torch.equal(L.log_likelihood(x, lab), want[..., 0])


# ---------------------------------------------------------------------------
# The mesh paths: two gloo ranks, a (1, 2) ("data", "model") mesh
# ---------------------------------------------------------------------------

def _mesh_paths_job():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch import sharding as shd
    from repro_torch.configs.base import ModelConfig
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((1, 2), ("data", "model"), "cpu")
    rng = np.random.default_rng(0)
    out = {}

    def put(t, *pl):
        return distribute_tensor(t, mesh, pl, src_data_rank=None)

    # split-T: the cache's T over "model", q's heads over "model"
    cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=32,
                      n_heads=4, n_kv_heads=2, head_dim=8, d_ff=32,
                      vocab_size=16)
    _, (q, k, v) = _qkv(rng, 2, 16, 4, 2, 8)
    calls = []
    plain = attn.combine_partials
    attn.combine_partials = lambda *a: calls.append(1) or plain(*a)
    try:
        for kv_len in (3, 8, 9, 16):
            got = attn.attention_core(
                cfg, put(q, Replicate(), Shard(2)),
                put(k, Replicate(), Shard(1)), put(v, Replicate(), Shard(1)),
                causal=False, kv_len=kv_len)
            want = attn.attention_full(q, k, v, causal=False, kv_len=kv_len)
            out[f"attn{kv_len}"] = float((got.full_tensor() - want).abs().max())
            out[f"attn{kv_len}_placements"] = str(got.placements)
    finally:
        attn.combine_partials = plain
    out["split_calls"] = len(calls)

    # the log-likelihood and its gradient, the logits' vocab over "model"
    x = torch.as_tensor(rng.normal(size=(2, 3, 16)) * 3, dtype=torch.float32)
    lab = torch.as_tensor(rng.integers(0, 16, (2, 3)))
    lab[0, :2] = torch.tensor([7, 8])                 # either side of the cut
    w = torch.as_tensor(rng.normal(size=(2, 3)), dtype=torch.float32)
    xp = x.clone().requires_grad_(True)
    want = L.log_likelihood(xp, lab)
    (want * w).sum().backward()
    xd = put(x, Replicate(), Shard(2)).requires_grad_(True)
    got = L.log_likelihood(xd, put(lab, Replicate(), Replicate()))
    (got * put(w, Replicate(), Replicate())).sum().backward()
    out["ll"] = float((got.full_tensor() - want).abs().max())
    out["ll_grad"] = float((xd.grad.full_tensor() - xp.grad).abs().max())
    out["ll_placements"] = str(xd.grad.placements)
    # a vocab "sharded" over the one rank of "data" is whole: the
    # single-device arithmetic, bit for bit, no partials combined
    calls.clear()
    plain_ll = L.combine_vocab_partials
    L.combine_vocab_partials = lambda *a: calls.append(1) or plain_ll(*a)
    try:
        x1 = put(x, Shard(2), Replicate()).requires_grad_(True)
        got = L.log_likelihood(x1, put(lab, Replicate(), Replicate()))
        (got * put(w, Replicate(), Replicate())).sum().backward()
    finally:
        L.combine_vocab_partials = plain_ll
    out["ll_one_rank"] = (torch.equal(got.full_tensor(), want.detach()),
                          torch.equal(x1.grad.full_tensor(), xp.grad),
                          len(calls))

    # the greedy pick: ties inside a shard and across the cut go to the
    # smallest index
    g = torch.as_tensor(rng.normal(size=(4, 1, 16)), dtype=torch.float32)
    g[0, 0, [2, 5, 11]] = 9.0        # the first shard's first
    g[1, 0, [9, 12]] = 9.0           # the second shard only
    g[2, 0, [7, 8]] = 9.0            # either side of the cut
    g[3, 0, [15]] = 9.0              # the last column
    pick = shd.argmax_sharded(put(g, Replicate(), Shard(2)))
    out["argmax"] = pick.full_tensor()[:, 0].tolist()
    out["argmax_plain"] = g.argmax(-1)[:, 0].tolist()
    return out


def test_mesh_paths_on_two_ranks(tmp_path):
    out = spawn(_mesh_paths_job, 2, timeout_s=120, store_dir=str(tmp_path))
    assert out[0] == out[1]
    out = out[0]
    for kv_len in (3, 8, 9, 16):
        assert out[f"attn{kv_len}"] < 1e-5, out
        # the result takes q's layout again
        assert out[f"attn{kv_len}_placements"] == \
            "(Replicate(), Shard(dim=2))"
    assert out["split_calls"] == 4
    assert out["ll"] < 1e-5 and out["ll_grad"] < 1e-6, out
    assert out["ll_placements"] == "(Replicate(), Shard(dim=2))"
    assert out["ll_one_rank"] == (True, True, 0)
    assert out["argmax"] == out["argmax_plain"] == [2, 9, 7, 15]
