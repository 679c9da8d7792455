"""ssd's tensor-core design, as far as it holds without a card: the dispatch
predicate, the geometry and the layouts it reads as they lie (plain Python),
the shape of the CUDA source, and the plain version held against the JAX
package's kernel (interpret-mode Pallas) and oracle at the shapes the card
test sends to that design: P = N = 64, a head count that is no multiple of
its head group, ragged T. The CUDA kernel itself is held against the plain
version on the card by ``tests/test_torch_recurrence_card.py``, whose cases
(wkv6's too) are checked here first."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import ssd as ssd_mod
from repro_torch.kernels import wkv6 as wk

import test_torch_recurrence_card as rec_card

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
    # B and C in groups: each head pair inside one group
    ("2 groups of 56 heads", _x(h=112), torch.zeros((2, 40, 2, 64)), True),
    ("3 groups of 2 heads", _x(h=6), torch.zeros((2, 40, 3, 64)), True),
    ("2 groups of 3 heads", _x(h=6), torch.zeros((2, 40, 2, 64)), False),
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
    # The cp.async copies and the 3xTF32 product are shared with wkv6, in
    # hopper.cuh, which the tensor-core design uses.
    hdr = (CSRC / "hopper.cuh").read_text()
    assert '#include "hopper.cuh"' in src and "using namespace hopper;" in tc
    for call in ("cp16(", "cp4(", "cp.async.commit_group", "cp.async.wait_group 1",
                 "mma3(", "split4(", "split2("):
        assert call in tc, call
    for ptx in ("cp.async.cg.shared.global", "cp.async.ca.shared.global",
                "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32"):
        assert ptx in hdr, ptx
    # hi: v's top 19 bits (TF32); lo: the exact rest.
    split = hdr.split("void split_into(")[1].split("\n}\n")[0]
    assert "0xffffe000u" in split and "v - __uint_as_float(hi)" in split
    # Three TF32 products for each f32 one: lo*hi, hi*lo, hi*hi.
    body = hdr.split("void mma3(")[1].split("\n}\n")[0]
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


# ---- the first design's padding, through a stand-in for its C entry ---------

def _as_tensor(ptr, shape, dtype):
    """The CPU memory at ``ptr`` as a tensor of ``shape`` (no copy)."""
    import ctypes
    n = int(np.prod(shape))
    ctype = {torch.float32: ctypes.c_float, torch.bfloat16: ctypes.c_uint16}[dtype]
    return torch.frombuffer((ctype * n).from_address(ptr), dtype=dtype).view(*shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sizes_6_run_the_first_design_zero_padded_to_8(monkeypatch, rng, dtype):
    # The card's wrapper, with the tensors passed off as CUDA ones and the C
    # entry replaced by the plain version on the memory it is handed: the
    # entry sees P = N = 8 (zero columns of x, b and c), and the wrapper's
    # output, sliced back to P = 6, equals the unpadded function.
    seen = []

    def entry(source, name, argtypes):
        assert (source, name) == ("ssd", "ssd_forward")

        def fake(x, a, b, c, y, dt, bb, h, t, p, n, chunk, stream):
            tdt = (torch.float32, torch.bfloat16)[dt]
            xs = _as_tensor(x, (bb, h, t, p), tdt)
            bs, cs = (_as_tensor(q, (bb, t, n), torch.float32) for q in (b, c))
            seen.append((p, n, float(xs[..., 6:].abs().sum() + bs[..., 6:].abs().sum()
                                     + cs[..., 6:].abs().sum())))
            _as_tensor(y, (bb, h, t, p), tdt).copy_(
                ssd_mod.ssd_plain(xs, _as_tensor(a, (bb, h, t), torch.float32), bs, cs))
            return 0
        return fake

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(ssd_mod._build, "entry", entry)
    monkeypatch.setattr(ssd_mod._build, "stream", lambda t: 0)
    monkeypatch.setattr(ssd_mod, "launches", 0)
    monkeypatch.setattr(ssd_mod, "tc_launches", 0)
    b, h, t = 2, 3, 45
    x = torch.from_numpy(rng.normal(size=(b, h, t, 6)).astype(np.float32)).to(dtype)
    a = torch.from_numpy(-np.abs(rng.normal(size=(b, h, t))).astype(np.float32) * 0.5)
    bm, cm = (torch.from_numpy(rng.normal(size=(b, t, 6)).astype(np.float32)) for _ in range(2))
    got = ssd_mod.ssd_cuda(x, a, bm, cm, chunk=32)
    assert seen == [(8, 8, 0.0)] and (ssd_mod.launches, ssd_mod.tc_launches) == (1, 0)
    assert got.shape == (b, h, t, 6) and got.dtype == dtype
    rtol, atol = {torch.float32: (1e-3, 1e-3), torch.bfloat16: (2e-2, 2e-1)}[dtype]
    np.testing.assert_allclose(_np(got), _np(ssd_mod.ssd_plain(x, a, bm, cm)), rtol=rtol, atol=atol)


def test_recurrence_card_cases_take_the_design_they_name():
    # The card test's case table (wkv6 and ssd): every case valid for the
    # wrapper, the predicate taking the design the case names.
    for name, (kernel, shape, dtype, tc) in rec_card.CASES.items():
        ins = rec_card.case_inputs(name)
        assert tuple(ins[0].shape) == tuple(shape[:4]), name
        assert ins[0].dtype == dtype, name
        (wk if kernel == "wkv6" else ssd_mod)._check(*ins)
        assert rec_card.tc_eligible(kernel, ins) == tc, name
