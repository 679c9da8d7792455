"""The port's flash attention (``repro_torch.kernels``) held against the JAX
package's kernel (interpret-mode Pallas, as tests/test_kernels.py runs it)
and its jnp oracle, on the same numpy inputs. On the CPU the port's wrapper
takes the kernel's plain version; the CUDA kernel itself is held against
that plain version on the card by ``chip_smoke.py``. Then ``ops.rope``'s
plain version and the checks of its card entry (the kernel on the card:
``tests/test_torch_rope_card.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rope as rope_k
from repro_torch.models.layers import apply_rope

import test_torch_rope_card as rope_card

TOL = {"float32": 2e-4, "bfloat16": 2e-2}   # tests/test_kernels.py:70-71
SHAPES = [  # (b, s, h, kv, d, bq, bk): tests/test_kernels.py:55-60
    (2, 128, 4, 4, 32, 64, 64),     # MHA
    (1, 256, 8, 2, 64, 128, 64),    # GQA 4:1
    (2, 128, 8, 1, 32, 64, 128),    # MQA
    (1, 96, 4, 2, 16, 64, 64),      # unaligned S (the JAX side takes its
                                    # reference path; the port has no tiles)
    # Head sizes the reference takes and the card runs on the next instance
    # up (48), on instances of their own (96, 256) or in slabs of 128
    # columns (320, 512), GQA 2:1.
    (1, 128, 4, 2, 48, 64, 64),
    (1, 128, 4, 2, 96, 64, 64),
    (1, 128, 4, 2, 256, 64, 64),
    (1, 128, 4, 2, 320, 64, 64),
    (1, 128, 4, 2, 512, 64, 64),
]


def _pair(rng, shape, dtype):
    """The same values as a jax array and a torch tensor (bf16 rounds from
    the same f32 numbers in both frameworks)."""
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(
        getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,d,bq,bk", SHAPES)
def test_flash_attention_matches_jax(rng, causal, dtype, b, s, h, kv, d, bq, bk):
    qj, qt = _pair(rng, (b, s, h, d), dtype)
    kj, kt = _pair(rng, (b, s, kv, d), dtype)
    vj, vt = _pair(rng, (b, s, kv, d), dtype)
    before = fa.launches
    got = ops.flash_attention(qt, kt, vt, causal=causal)
    assert fa.launches == before  # the CPU path launches no kernel
    assert got.shape == (b, s, h, d) and got.dtype == qt.dtype
    pallas = jops.flash_attention(qj, kj, vj, causal=causal, bq=bq, bk=bk)
    oracle = jref.attention_ref(qj.swapaxes(1, 2), kj.swapaxes(1, 2),
                                vj.swapaxes(1, 2), causal=causal).swapaxes(1, 2)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(pallas), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(got), _np(oracle), rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_ref_matches_jax_ref(rng, causal, dtype):
    qj, qt = _pair(rng, (2, 8, 48, 32), dtype)
    kj, kt = _pair(rng, (2, 2, 48, 32), dtype)
    vj, vt = _pair(rng, (2, 2, 48, 32), dtype)
    got = ref.attention_ref(qt, kt, vt, causal=causal)
    want = jref.attention_ref(qj, kj, vj, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_matches_oracle_with_ragged_kv(rng, causal):
    # Sq != Sk: positions count from 0 for q and k alike (no q offset).
    q = torch.from_numpy(rng.normal(size=(1, 4, 40, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 2, 72, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(1, 2, 72, 16)).astype(np.float32))
    got = fa.flash_attention_bhsd(q, k, v, causal=causal)
    want = jref.attention_ref(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                              jnp.asarray(v.numpy()), causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


def test_cuda_entry_rejects_cpu_tensors():
    q = torch.zeros((1, 2, 8, 16))
    k = torch.zeros((1, 1, 8, 16))
    before = fa.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_cuda(q, k, k, causal=True)
    assert fa.launches == before


@pytest.mark.parametrize("dtype,d", [(torch.float16, 16)])
def test_unsupported_inputs_raise(dtype, d):
    q = torch.zeros((1, 2, 8, d), dtype=dtype)
    k = torch.zeros((1, 1, 8, d), dtype=dtype)
    with pytest.raises(ValueError):
        fa.flash_attention_bhsd(q, k, k, causal=True)


@pytest.mark.parametrize("d", [48, 96, 256, 300])
def test_card_entry_refuses_cpu_tensors_before_any_size_check(d):
    # At every head size, the slab sizes above 256 (300) included, the
    # card entry's first refusal is the device, and no launch is counted;
    # the CPU path computes every size.
    q = torch.ones((1, 2, 8, d))
    k = torch.ones((1, 1, 8, d))
    before = (fa.launches, fa.wgmma_launches)
    for entry in (fa.flash_attention_cuda, fa.flash_attention_fma):
        with pytest.raises(ValueError, match="CUDA tensors"):
            entry(q, k, k, causal=True)
    assert (fa.launches, fa.wgmma_launches) == before
    got = fa.flash_attention_bhsd(q, k, k, causal=True)
    assert got.shape == q.shape and torch.allclose(got, torch.ones_like(q))


def test_library_path_hashes_the_shared_headers(tmp_path, monkeypatch):
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "k.cu").write_text('#include "hopper.cuh"\n')
    header = tmp_path / "csrc" / "hopper.cuh"
    header.write_text("// v1\n")
    first = _build.library_path("k")
    assert first.parent == tmp_path / "build" and first.name.startswith("k_")
    assert _build.library_path("k") == first          # unchanged: no rebuild
    header.write_text("// v2\n")
    assert _build.library_path("k") != first          # edited header: rebuild
    header.write_text("// v1\n")
    assert _build.library_path("k") == first
    (tmp_path / "csrc" / "extra.h").write_text("#pragma once\n")
    assert _build.library_path("k") != first          # a new header counts too


# ---------------------------------------------------------------------------
# RoPE of q and k (``ops.rope``; the kernel itself is held on the card by
# tests/test_torch_rope_card.py on the same cases)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,heads,pos", rope_card.CASES)
def test_rope_plain_is_apply_rope(d, heads, pos, dtype):
    q, k, p = rope_card.case_inputs(d, heads, pos, dtype)
    got_q, got_k = ops.rope(q, k, p, rope_card.THETA)
    assert torch.equal(got_q, apply_rope(q, p, rope_card.THETA))
    assert torch.equal(got_k, apply_rope(k, p, rope_card.THETA))


def _refusing_entry(*a, **k):
    raise AssertionError("the kernel was built or launched")


@pytest.mark.parametrize("bad", ["cpu", "odd_d", "float16", "not_contiguous"])
def test_rope_card_entry_refuses_before_any_launch(bad, monkeypatch):
    # On the CPU every refusal of the card entry is the device, first; the
    # checks that follow it refuse odd D, f16 and a non-contiguous q.
    monkeypatch.setattr(rope_k._build, "entry", _refusing_entry)
    q, k, p = rope_card.case_inputs(64, "gqa", "shared", torch.bfloat16)
    if bad == "odd_d":
        q, k = q[..., :63].contiguous(), k[..., :63].contiguous()
    elif bad == "float16":
        q, k = q.half(), k.half()
    elif bad == "not_contiguous":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    before = rope_k.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        rope_k.rope_cuda(q, k, p, rope_card.THETA)
    if bad != "cpu":
        with pytest.raises(ValueError, match="rope takes"):
            rope_k._check_card(q, k, p)
    assert rope_k.launches == before


def test_rope_refuses_a_dtensor():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch.dryrun import fake_group

    q, k, p = rope_card.case_inputs(64, "gqa", "shared", torch.float32)
    with fake_group(1):
        mesh = init_device_mesh("cpu", (1,))
        dq = DTensor.from_local(q, mesh, [Replicate()], run_check=False)
        with pytest.raises(RuntimeError, match="takes no DTensor"):
            ops.rope(dq, k, p, rope_card.THETA)


def test_rope_refuses_a_gradient():
    q, k, p = rope_card.case_inputs(64, "gqa", "shared", torch.float32)
    with pytest.raises(RuntimeError, match="use_kernels=False"):
        ops.rope(q.requires_grad_(True), k, p, rope_card.THETA)
    with torch.no_grad():   # the same call outside autograd runs
        got_q, _ = ops.rope(q, k, p, rope_card.THETA)
    assert got_q.grad_fn is None
