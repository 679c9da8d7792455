"""The port's relic_matmul and relic_matmul_gated (``repro_torch.kernels``)
held against the JAX package's kernels (interpret-mode Pallas, as
tests/test_kernels.py runs them) and oracles, on the same numpy inputs, at
the shapes, types and tolerances of tests/test_kernels.py:23-50. On the CPU
the port's wrappers take the kernels' plain versions; the CUDA kernels are
held against those plain versions on the card by ``chip_smoke.py``.

Also here: every kernel wrapper of the port refuses a gradient, on the CPU
as on the card, as the reference refuses ``jax.grad`` through its kernels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import relic_matmul as rm
from repro_torch.kernels import ssd as ssd_k
from repro_torch.kernels import wkv6 as wkv6_k

TOL = {"float32": 2e-4, "bfloat16": 2e-1}   # tests/test_kernels.py:20
SHAPES = [  # (m, n, k, bm, bn, bk): tests/test_kernels.py:24-29
    (128, 128, 128, 128, 128, 128),
    (256, 384, 512, 128, 128, 256),
    (512, 256, 1024, 256, 256, 512),
    (100, 60, 36, 128, 128, 128),   # unaligned: the JAX side takes its oracle
]


def _pair(rng, shape, dtype):
    """The same values as a jax array and a torch tensor."""
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(
        getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,k,bm,bn,bk", SHAPES)
def test_matmul_matches_jax(rng, dtype, m, n, k, bm, bn, bk):
    xj, xt = _pair(rng, (m, k), dtype)
    yj, yt = _pair(rng, (k, n), dtype)
    before = rm.launches
    got = ops.matmul(xt, yt, bm=bm, bn=bn, bk=bk)
    assert rm.launches == before  # the CPU path launches no kernel
    assert got.shape == (m, n) and got.dtype == xt.dtype
    tol = TOL[dtype]
    for want in (jops.matmul(xj, yj, bm=bm, bn=bn, bk=bk), jref.matmul_ref(xj, yj)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol * 50)


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_gated_matches_jax(rng, act, dtype):
    xj, xt = _pair(rng, (256, 256), dtype)
    gj, gt = _pair(rng, (256, 128), dtype)
    uj, ut = _pair(rng, (256, 128), dtype)
    before = rm.gated_launches
    got = ops.matmul_gated(xt, gt, ut, act=act, bm=128, bn=128, bk=128)
    assert rm.gated_launches == before
    assert got.shape == (256, 128) and got.dtype == xt.dtype
    atol = 2.0 if dtype == "bfloat16" else 2e-2   # tests/test_kernels.py:48-50
    for want in (jops.matmul_gated(xj, gj, uj, act=act, bm=128, bn=128, bk=128),
                 jref.matmul_gated_ref(xj, gj, uj, act)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=atol)


@pytest.mark.parametrize("act", ["relu", "none", ""])
def test_unknown_activation_leaves_the_gate_unactivated(rng, act):
    xj, xt = _pair(rng, (64, 96), "float32")
    gj, gt = _pair(rng, (96, 32), "float32")
    uj, ut = _pair(rng, (96, 32), "float32")
    got = ops.matmul_gated(xt, gt, ut, act=act)
    np.testing.assert_allclose(_np(got), _np((xt @ gt) * (xt @ ut)),
                               rtol=1e-5, atol=1e-4)
    for want in (jops.matmul_gated(xj, gj, uj, act=act, bm=64, bn=32, bk=96),
                 jref.matmul_gated_ref(xj, gj, uj, act)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=1e-2)


@pytest.mark.parametrize("act", ["silu", "gelu", "none"])
def test_matmul_gated_ref_matches_jax_ref(rng, act):
    xj, xt = _pair(rng, (48, 40), "float32")
    gj, gt = _pair(rng, (40, 24), "float32")
    uj, ut = _pair(rng, (40, 24), "float32")
    np.testing.assert_allclose(_np(ref.matmul_gated_ref(xt, gt, ut, act)),
                               _np(jref.matmul_gated_ref(xj, gj, uj, act)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("x_dtype,out_dtype", [("float32", "bfloat16"),
                                               ("bfloat16", "float32"),
                                               ("float32", "float32")])
def test_out_dtype(rng, x_dtype, out_dtype):
    xj, xt = _pair(rng, (40, 24), x_dtype)
    yj, yt = _pair(rng, (24, 16), x_dtype)
    od = getattr(torch, out_dtype)
    got = rm.relic_matmul(xt, yt, out_dtype=od)
    assert got.dtype == od
    want = jref.matmul_ref(xj, yj, out_dtype=getattr(jnp, out_dtype))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-2, atol=1e-2)
    gated = rm.relic_matmul_gated(xt, yt, yt, act="gelu", out_dtype=od)
    assert gated.dtype == od
    want = jref.matmul_gated_ref(xj, yj, yj, "gelu", out_dtype=getattr(jnp, out_dtype))
    np.testing.assert_allclose(_np(gated), _np(want), rtol=1e-2, atol=1e-1)


BAD = {
    "inner dims": lambda: ((torch.zeros(4, 8), torch.zeros(6, 3)), {}),
    "not 2-D": lambda: ((torch.zeros(2, 4, 8), torch.zeros(8, 3)), {}),
    "mixed dtypes": lambda: ((torch.zeros(4, 8), torch.zeros(8, 3, dtype=torch.bfloat16)), {}),
    "float16": lambda: ((torch.zeros(4, 8, dtype=torch.float16),
                         torch.zeros(8, 3, dtype=torch.float16)), {}),
    "int out_dtype": lambda: ((torch.zeros(4, 8), torch.zeros(8, 3)),
                              {"out_dtype": torch.int32}),
    "empty": lambda: ((torch.zeros(0, 8), torch.zeros(8, 3)), {}),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_matmul_rejects_bad_inputs(case):
    (x, y), kw = BAD[case]()
    with pytest.raises(ValueError):
        rm.relic_matmul(x, y, **kw)
    with pytest.raises(ValueError):
        rm.relic_matmul_gated(x, y, y, **kw)


def test_matmul_gated_rejects_unequal_weights():
    with pytest.raises(ValueError):
        rm.relic_matmul_gated(torch.zeros(4, 8), torch.zeros(8, 3),
                              torch.zeros(8, 5))


def test_cuda_entries_reject_cpu_tensors():
    x, y = torch.zeros(4, 8), torch.zeros(8, 3)
    before = (rm.launches, rm.gated_launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rm.relic_matmul_cuda(x, y)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rm.relic_matmul_gated_cuda(x, y, y)
    assert (rm.launches, rm.gated_launches) == before


# ---------------------------------------------------------------------------
# no gradient through a kernel, on any device
# ---------------------------------------------------------------------------

def _inputs(name):
    """(wrapper, args, kwargs) of each kernel wrapper at a small shape."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g)

    if name == "relic_matmul":
        return rm.relic_matmul, (r(8, 16), r(16, 4)), {}
    if name == "relic_matmul_gated":
        return rm.relic_matmul_gated, (r(8, 16), r(16, 4), r(16, 4)), {}
    if name == "flash_attention":
        return fa.flash_attention_bhsd, (r(1, 2, 8, 16), r(1, 1, 8, 16),
                                         r(1, 1, 8, 16)), {"causal": True}
    if name == "wkv6":
        return wkv6_k.wkv6_bhtk, (r(1, 2, 8, 4), r(1, 2, 8, 4), r(1, 2, 8, 4),
                                  -torch.exp(r(1, 2, 8, 4)), r(2, 4)), {"chunk": 4}
    return ssd_k.ssd_bhtp, (r(1, 2, 8, 4), -r(1, 2, 8).abs(), r(1, 8, 4),
                            r(1, 8, 4)), {"chunk": 4}


WRAPPERS = ["relic_matmul", "relic_matmul_gated", "flash_attention", "wkv6", "ssd"]


@pytest.mark.parametrize("arg", [0, -1])
@pytest.mark.parametrize("name", WRAPPERS)
def test_kernel_wrappers_refuse_gradients(name, arg):
    fn, args, kw = _inputs(name)
    args = list(args)
    args[arg] = args[arg].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="use_kernels=False"):
        fn(*args, **kw)
    with torch.no_grad():   # the same call outside autograd runs
        out = fn(*args, **kw)
    assert out.grad_fn is None and torch.isfinite(out).all()
