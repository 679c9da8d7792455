"""wkv6's tensor-core design, as far as it holds without a card: the dispatch
predicate, the layouts it reads as they lie and the ones it copies first
(plain Python), the shape of the CUDA source, and a plain-torch model of
its factored arithmetic (sub-chunk decays, chunks of 32 steps) held against
the JAX package's kernel (interpret-mode Pallas) and oracle with aggressive
decays, at the served head size K = 64 and ragged T. The model lives here,
not in the package: the wrapper's plain version stays the oracle, and the
CUDA kernel is held against it on the card (test_torch_recurrence_card.py)."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import wkv6 as wk

CSRC = Path(wk.__file__).resolve().parent / "csrc"
KTOL = 1e-3   # f32: tests/test_kernels.py:88-93


def _bhtk(k=64, dtype=torch.float32, b=2, h=3, t=40):
    return torch.zeros((b, h, t, k), dtype=dtype)


def _model_layout(k=64, dtype=torch.float32, b=2, h=3, t=40):
    """A [B, H, T, K] view of a contiguous [B, T, H, K] tensor, as
    ``ops.wkv6`` hands the model's tensors over."""
    return torch.zeros((b, t, h, k), dtype=dtype).transpose(1, 2)


@pytest.mark.parametrize("case,r,want", [
    ("f32, K = 64", _bhtk(), True),
    ("bf16, K = 64", _bhtk(dtype=torch.bfloat16), True),
    ("model layout", _model_layout(dtype=torch.bfloat16), True),
    ("K = 32", _bhtk(k=32), False),
    ("K = 16", _bhtk(k=16, dtype=torch.bfloat16), False),
    ("K = 6", _bhtk(k=6), False),
])
def test_predicate_takes_head_size_64(case, r, want):
    assert wk.tc_eligible(r) is want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_model_layout_is_read_and_written_as_it_lies(dtype):
    r = _model_layout(dtype=dtype)
    assert not r.is_contiguous() and wk.cp_async_rows(r)
    assert wk.tc_layout(r) is r
    # The output allocated like r keeps the model layout, so ops.wkv6's
    # transpose back is contiguous, and the kernel can write it in rows.
    out = torch.empty_like(r)
    assert out.stride() == r.stride() and out.transpose(1, 2).is_contiguous()
    assert wk.cp_async_rows(out)


@pytest.mark.parametrize("case,make", [
    ("storage offset", lambda: torch.zeros(1 + 2 * 3 * 40 * 64)[1:].view(2, 3, 40, 64)),
    ("bf16 rows 68 apart (136 bytes)",
     lambda: torch.zeros((2, 3, 40, 68), dtype=torch.bfloat16)[..., :64]),
    ("K strided", lambda: torch.zeros((2, 3, 40, 128))[..., ::2]),
    ("bf16 steps 1 row apart in a [B, T, H] layout of odd H",
     lambda: torch.zeros((2, 40, 3, 68), dtype=torch.bfloat16)[..., 2:66].transpose(1, 2)),
])
def test_layouts_cp_async_cannot_read_are_copied_first(case, make):
    x = make()
    assert not wk.cp_async_rows(x)
    y = wk.tc_layout(x)
    assert wk.cp_async_rows(y) and torch.equal(y, x)


def test_cuda_entry_rejects_cpu_tensors_before_any_design():
    for kk in (64, 6):
        x = _bhtk(k=kk, t=8)
        before = (wk.launches, wk.tc_launches)
        with pytest.raises(ValueError, match="CUDA tensors"):
            wk.wkv6_cuda(x, x, x, x, torch.zeros((3, kk)))
        assert (wk.launches, wk.tc_launches) == before


def _tc_source():
    src = (CSRC / "wkv6.cu").read_text()
    return src, src.split("namespace tc {")[1].split("}  // namespace tc")[0]


def test_source_loads_asynchronously_and_runs_3xtf32_from_the_shared_header():
    src, tc = _tc_source()
    hdr = (CSRC / "hopper.cuh").read_text()
    assert '#include "hopper.cuh"' in src
    for call in ("cp16(", "cp_async_commit()", "cp_async_wait<1>()", "mma3(",
                 "split4(", "split2(", "__shfl_up_sync("):
        assert call in tc, call
    for ptx in ("cp.async.cg.shared.global", "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32"):
        assert ptx in hdr, ptx
    # The helpers live once, in the header: neither kernel defines its own.
    for name in ("void split_into(", "void mma3(", "void cp16("):
        assert name in hdr and name not in src
        assert name not in (CSRC / "ssd.cu").read_text()
    # The split masks bits; no PTX string rounds with cvt.rna.
    assert '"cvt.rna' not in src and '"cvt.rna' not in hdr
    assert "constexpr int SUB = 16;" in tc and "constexpr int L = 32;" in tc
    assert 'extern "C" int wkv6_tc_forward(' in src
    assert 'extern "C" int wkv6_forward(' in src   # the first design stays


def test_no_exponent_above_zero_and_none_per_pair():
    _, tc = _tc_source()
    # The off-diagonal block is a product of factored operands, each scaled
    # by an exponential of a difference <= 0 (clamped against rounding).
    assert "RQ[(tt - SUB) * RS + c] = rv * __expf(fminf(lp - gc, 0.f));" in tc
    assert "KQ[tt * RS + c] = kv * __expf(fminf(gc - la, 0.f));" in tc
    # The diagonal blocks multiply running products of the step decays
    # w = exp(lw) <= 1: no exponential per (t, s, channel).
    diag = tc.split("// ---- the diagonal blocks.")[1].split("__syncthreads();")[0]
    assert "__expf" not in diag and "dec[e] * ww[e]" in diag
    assert "W[(q0 + q) * RS + c] = __expf(x);" in tc


def test_shared_memory_leaves_room_for_two_ctas_per_sm():
    _, tc = _tc_source()

    def const(name):
        return int(tc.split(f"constexpr int {name} = ")[1].split(";")[0].split()[0])

    L, SUB, K, RS = const("L"), const("SUB"), const("K"), const("RS")
    work = 4 * (3 * L * RS + 2 * SUB * RS + L * (L + 4) + K)
    f32_buf = 3 * L * RS * 4 + L * RS * 4
    # An H100 SM has 228 KB of shared memory, 1 KB of it reserved per CTA.
    assert 2 * (2 * f32_buf + work + 1024) <= 228 * 1024


# ---- the factored arithmetic against the JAX package ------------------------

def factored_wkv6(r, k, v, lw, u, L=32, SUB=16):
    """The tensor-core design's arithmetic in plain torch f32, per chunk of
    L steps: inside each sub-chunk of SUB steps the decay of a pair as the
    running product of the step decays exp(lw) between them; across
    sub-chunks the decay factored through g = la at the last step before the
    second sub-chunk (both exponents <= 0); the state carried across
    chunks. [B, H, T, K] in, [B, H, T, K] f32 out."""
    b, h, t, kk = r.shape
    r, k, v, lw = (x.float() for x in (r, k, v, lw))
    state = torch.zeros((b, h, kk, kk))
    outs = []
    for t0 in range(0, t, L):
        n = min(L, t - t0)
        pad = (0, 0, 0, L - n)
        rc, kc, vc, wc = (torch.nn.functional.pad(x[:, :, t0:t0 + n], pad)
                          for x in (r, k, v, lw))
        la = torch.cumsum(wc, dim=2)
        lp = la - wc
        w = torch.exp(wc)
        g, le = la[:, :, SUB - 1], la[:, :, -1]
        p = torch.zeros((b, h, L, L))
        for base in range(0, L, SUB):
            for tt in range(base, base + SUB):
                p[:, :, tt, tt] = (rc[:, :, tt] * u * kc[:, :, tt]).sum(-1)
                dec = torch.ones((b, h, kk))
                for ss in range(tt - 1, base - 1, -1):
                    p[:, :, tt, ss] = (rc[:, :, tt] * kc[:, :, ss] * dec).sum(-1)
                    dec = dec * w[:, :, ss]
        rq = rc[:, :, SUB:] * torch.exp(torch.clamp(lp[:, :, SUB:] - g[:, :, None], max=0))
        kq = kc[:, :, :SUB] * torch.exp(torch.clamp(g[:, :, None] - la[:, :, :SUB], max=0))
        p[:, :, SUB:, :SUB] = rq @ kq.transpose(-1, -2)
        out = p @ vc + (rc * torch.exp(lp)) @ state
        outs.append(out[:, :, :n])
        kd = kc * torch.exp(torch.clamp(le[:, :, None] - la, max=0))
        state = state * torch.exp(le)[..., None] + kd.transpose(-1, -2) @ vc
    return torch.cat(outs, dim=2)


def _inputs(rng, b, t, h, k=64):
    """Model layout [B, T, H, K]; the aggressive decays of
    tests/test_kernels.py:84."""
    def pair(x):
        x = np.asarray(x, np.float32)
        return jnp.asarray(x), torch.from_numpy(x)
    r, kk, v = (pair(rng.normal(size=(b, t, h, k))) for _ in range(3))
    lw = pair(-np.exp(rng.normal(size=(b, t, h, k))))
    return r, kk, v, lw, pair(rng.normal(size=(h, k)))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("b,t,h,chunk", [
    (1, 64, 2, 64),     # the Pallas kernel's tiles divide these
    (2, 128, 2, 64),
    (1, 45, 2, 64),     # ragged T: a sub-chunk partly valid; JAX takes its oracle
    (2, 77, 3, 64),     # ragged, three chunks of 32
    (1, 96, 2, 64),     # T = 96 with chunk 64: ragged for the model's chunk
    (1, 7, 2, 64),      # shorter than one sub-chunk
])
def test_factored_form_matches_jax(rng, b, t, h, chunk):
    (rj, rt), (kj, kt), (vj, vt), (wj, wt), (uj, ut) = _inputs(rng, b, t, h)
    bhtk = [x.transpose(1, 2) for x in (rt, kt, vt, wt)]
    got = factored_wkv6(*bhtk, ut).transpose(1, 2)
    assert np.isfinite(_np(got)).all()
    oracle = jref.wkv6_ref(*(a.swapaxes(1, 2) for a in (rj, kj, vj, wj)),
                           uj).swapaxes(1, 2)
    pallas = jops.wkv6(rj, kj, vj, wj, uj, chunk=chunk)
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got), _np(want), rtol=KTOL, atol=KTOL)
    # The port's wrapper on the CPU (its plain version) agrees too, and
    # launches nothing.
    before = (wk.launches, wk.tc_launches)
    port = ops.wkv6(rt, kt, vt, wt, ut, chunk=chunk)
    assert (wk.launches, wk.tc_launches) == before
    np.testing.assert_allclose(_np(got), _np(port), rtol=KTOL, atol=KTOL)


def test_factored_form_survives_decays_that_overflow_exp_of_minus_la(rng):
    # Decays of -60 a step: exp(-la) overflows f32 after two steps, so a
    # chunk-wide factoring would give inf * 0; the sub-chunk factoring keeps
    # every exponent <= 0, and the running products only underflow.
    (rj, rt), (kj, kt), (vj, vt), _, (uj, ut) = _inputs(rng, 1, 64, 2)
    lw = np.full((1, 64, 2, 64), -60.0, np.float32)
    bhtk = [x.transpose(1, 2) for x in (rt, kt, vt, torch.from_numpy(lw))]
    got = factored_wkv6(*bhtk, ut).transpose(1, 2)
    assert np.isfinite(_np(got)).all()
    oracle = jref.wkv6_ref(*(a.swapaxes(1, 2) for a in (rj, kj, vj, jnp.asarray(lw))),
                           uj).swapaxes(1, 2)
    np.testing.assert_allclose(_np(got), _np(oracle), rtol=KTOL, atol=KTOL)


# ---- the first design's padding, through a stand-in for its C entry ---------

def _as_tensor(ptr, shape, dtype):
    """The CPU memory at ``ptr`` as a tensor of ``shape`` (no copy)."""
    import ctypes
    n = int(np.prod(shape))
    ctype = {torch.float32: ctypes.c_float, torch.bfloat16: ctypes.c_uint16}[dtype]
    buf = (ctype * n).from_address(ptr)
    return torch.frombuffer(buf, dtype=dtype).view(*shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_size_6_runs_the_first_design_zero_padded_to_8(monkeypatch, rng, dtype):
    # The card's wrapper, with the tensors passed off as CUDA ones and the C
    # entry replaced by the plain version on the memory it is handed: the
    # entry sees K = 8 (zero channels of r, k, v, logw and u), and the
    # wrapper's output, sliced back to K = 6, equals the unpadded function.
    seen = []

    def entry(source, name, argtypes):
        assert (source, name) == ("wkv6", "wkv6_forward")

        def fake(r, k, v, lw, u, out, dt, b, h, t, kk, chunk, stream):
            shape, tdt = (b, h, t, kk), (torch.float32, torch.bfloat16)[dt]
            ins = [_as_tensor(p, shape, tdt) for p in (r, k, v)]
            w, uu = _as_tensor(lw, shape, torch.float32), _as_tensor(u, (h, kk), torch.float32)
            seen.append((kk, float(ins[0][..., 6:].abs().sum() + w[..., 6:].abs().sum()
                                   + uu[:, 6:].abs().sum())))
            _as_tensor(out, shape, tdt).copy_(wk.wkv6_plain(*ins, w, uu))
            return 0
        return fake

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(wk._build, "entry", entry)
    monkeypatch.setattr(wk._build, "stream", lambda t: 0)
    monkeypatch.setattr(wk, "launches", 0)
    monkeypatch.setattr(wk, "tc_launches", 0)
    b, h, t, kk = 2, 3, 37, 6
    r, k, v = (torch.from_numpy(rng.normal(size=(b, h, t, kk)).astype(np.float32)).to(dtype)
               for _ in range(3))
    lw = torch.from_numpy(-np.exp(rng.normal(size=(b, h, t, kk))).astype(np.float32))
    u = torch.from_numpy(rng.normal(size=(h, kk)).astype(np.float32))
    got = wk.wkv6_cuda(r, k, v, lw, u, chunk=16)
    assert seen == [(8, 0.0)] and (wk.launches, wk.tc_launches) == (1, 0)
    assert got.shape == (b, h, t, kk) and got.dtype == dtype
    rtol, atol = {torch.float32: (1e-3, 1e-3), torch.bfloat16: (2e-2, 2e-1)}[dtype]
    np.testing.assert_allclose(_np(got), _np(wk.wkv6_plain(r, k, v, lw, u)), rtol=rtol, atol=atol)


def test_phase_script_finds_its_anchors_in_the_kernel():
    # wkv6_phases.py rewrites the kernel's text to time its phases on the
    # card; every loop it empties and every barrier it marks must exist.
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import wkv6_phases

    src = (CSRC / "wkv6.cu").read_text()
    for name, head in wkv6_phases.ABLATIONS.items():
        assert src.count(head) == 1, name
        assert wkv6_phases._empty_loop(src, head) != src
    profiled = wkv6_phases._profiled(src)
    assert profiled.count("PMARK(") == 1 + len(wkv6_phases.PHASES)
