"""ssd's tensor-core design, as far as it holds without a card: the dispatch
predicate, the geometry and the layouts it reads as they lie (plain Python),
the shape of the CUDA source, and the plain version held against the JAX
package's kernel (interpret-mode Pallas) and oracle at the shapes
``chip_smoke.py`` sends to that design: P = N = 64, a head count that is no
multiple of its head group, ragged T. The CUDA kernel itself is held against
the plain version on the card by ``chip_smoke.py``."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import ssd as ssd_mod

CSRC = Path(ssd_mod.__file__).resolve().parent / "csrc"


def _x(p=64, dtype=torch.float32, b=2, h=3, t=40):
    return torch.zeros((b, h, t, p), dtype=dtype)


def _bc(n=64, b=2, t=40):
    return torch.zeros((b, t, n))


@pytest.mark.parametrize("case,x,bmat,want", [
    ("f32, P = N = 64", _x(), _bc(), True),
    ("bf16", _x(dtype=torch.bfloat16), _bc(), False),
    ("P = 32", _x(p=32), _bc(), False),
    ("N = 16", _x(), _bc(n=16), False),
    ("P = 16, N = 8", _x(p=16), _bc(n=8), False),
])
def test_predicate_takes_f32_with_p_and_n_64(case, x, bmat, want):
    assert ssd_mod.tc_eligible(x, bmat) is want


def test_one_cta_per_batch_row_and_pair_of_heads():
    tc = (CSRC / "ssd.cu").read_text().split("namespace tc {")[1]
    assert "constexpr int HG = 2;" in tc
    # An odd H leaves the last group one head: the grid rounds up, and the
    # kernel skips the absent head's loads and stores.
    assert "ssd_tc_kernel<<<B * ((H + HG - 1) / HG)," in tc
    assert "const int heads = min(HG, H - h0);" in tc


def test_the_model_layout_is_read_as_it_lies():
    # ops.ssd hands over the model's [B, T, H, P] as a [B, H, T, P] view.
    x = torch.zeros((2, 40, 3, 64)).transpose(1, 2)
    assert not x.is_contiguous() and ssd_mod.cp_async_rows(x)
    # The output allocated like x keeps the model layout, so ops.ssd's
    # transpose back is contiguous.
    out = torch.empty_like(x)
    assert out.stride() == x.stride() and out.transpose(1, 2).is_contiguous()


@pytest.mark.parametrize("case,make", [
    ("storage offset", lambda: torch.zeros(1 + 2 * 3 * 40 * 64)[1:].view(2, 3, 40, 64)),
    ("rows 66 apart", lambda: torch.zeros((2, 3, 40, 66))[..., :64]),
    ("P strided", lambda: torch.zeros((2, 3, 40, 128))[..., ::2]),
])
def test_layouts_the_copies_cannot_read_are_copied_first(case, make):
    x = make()
    assert not ssd_mod.cp_async_rows(x)
    y = ssd_mod.tc_layout(x)
    assert ssd_mod.cp_async_rows(y) and torch.equal(y, x)


def test_readable_layouts_are_not_copied():
    x = torch.zeros((2, 40, 3, 64)).transpose(1, 2)
    bmat = torch.zeros((2, 40, 64))
    assert ssd_mod.tc_layout(x) is x and ssd_mod.tc_layout(bmat) is bmat


def test_a_misaligned_b_or_c_is_copied():
    bmat = torch.zeros(1 + 2 * 40 * 64)[1:].view(2, 40, 64)
    assert bmat.is_contiguous() and bmat.data_ptr() % 16
    out = ssd_mod.tc_layout(bmat)
    assert out.data_ptr() % 16 == 0 and torch.equal(out, bmat)


def test_cuda_entry_rejects_cpu_tensors_before_any_design():
    x = _x(t=8)
    before = (ssd_mod.launches, ssd_mod.tc_launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_mod.ssd_cuda(x, torch.zeros((2, 3, 8)), _bc(t=8), _bc(t=8))
    assert (ssd_mod.launches, ssd_mod.tc_launches) == before


def test_source_loads_asynchronously_and_runs_3xtf32_on_the_tensor_cores():
    src = (CSRC / "ssd.cu").read_text()
    tc = src.split("namespace tc {")[1].split("}  // namespace tc")[0]
    for ptx in ("cp.async.cg.shared.global", "cp.async.commit_group",
                "cp.async.wait_group 1",
                "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32"):
        assert ptx in tc, ptx
    # hi: v's top 19 bits (TF32); lo: the exact rest.
    split = tc.split("void split_into(")[1].split("\n}\n")[0]
    assert "0xffffe000u" in split and "v - __uint_as_float(hi)" in split
    # Three TF32 products for each f32 one: lo*hi, hi*lo, hi*hi.
    body = tc.split("void mma3(")[1].split("\n}\n")[0]
    assert body.count("mma_tf32(") == 3
    assert "a.lo, b.hi" in body and "a.hi, b.lo" in body and "a.hi, b.hi" in body
    # The decay exponent is taken only for s <= t and clamped at 0.
    assert "fminf(la0 - ls0, 0.f)" in tc and "s0 <= r0 ?" in tc
    assert 'extern "C" int ssd_tc_forward(' in src
    assert 'extern "C" int ssd_forward(' in src   # the first design stays


def test_shared_memory_leaves_room_for_two_ctas_per_sm():
    src = (CSRC / "ssd.cu").read_text()
    tc = src.split("namespace tc {")[1]

    def const(name):
        return tc.split(f"constexpr int {name} = ")[1].split(";")[0]

    vals = {}
    for name in ("L", "HG", "RS"):
        vals[name] = int(const(name).split()[0])
    vals["GS"] = vals["L"] + 4
    buf = (2 + vals["HG"]) * vals["L"] * vals["RS"] + vals["HG"] * vals["L"]
    floats = 2 * buf + vals["L"] * vals["GS"] + 3 * vals["HG"] * vals["L"]
    # An H100 SM has 228 KB of shared memory, 1 KB of it reserved per CTA.
    assert 2 * (4 * floats + 1024) <= 228 * 1024


# ---- against the JAX package, at the tensor-core design's shapes ------------

KTOL = 1e-3   # f32: tests/test_kernels.py:108-111


def _pair(x):
    x = np.asarray(x, np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _inputs(rng, b, t, h, p=64, n=64):
    x = _pair(rng.normal(size=(b, t, h, p)))
    a = _pair(-np.abs(rng.normal(size=(b, t, h))) * 0.5)
    return x, a, _pair(rng.normal(size=(b, t, n))), _pair(rng.normal(size=(b, t, n)))


@pytest.mark.parametrize("b,t,h,chunk", [
    (1, 128, 3, 64),    # H = 3: the last head group has one head; Pallas runs
    (2, 64, 5, 32),
    (1, 45, 3, 32),     # ragged T: the JAX side takes its oracle
    (2, 77, 5, 128),
])
def test_tensor_core_shapes_match_jax(rng, b, t, h, chunk):
    (xj, xt), (aj, at), (bj, bt), (cj, ct) = _inputs(rng, b, t, h)
    assert ssd_mod.tc_eligible(xt.transpose(1, 2), bt)
    before = (ssd_mod.launches, ssd_mod.tc_launches)
    got = ops.ssd(xt, at, bt, ct, chunk=chunk)
    assert (ssd_mod.launches, ssd_mod.tc_launches) == before   # no kernel on the CPU
    assert got.shape == (b, t, h, 64) and got.dtype == torch.float32
    pallas = jops.ssd(xj, aj, bj, cj, chunk=chunk)
    oracle = jref.ssd_ref(xj.swapaxes(1, 2), aj.swapaxes(1, 2), bj,
                          cj).swapaxes(1, 2)
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got), _np(want), rtol=KTOL, atol=KTOL)
