"""The wgmma flash-attention design's dispatch and TMA geometry, which are
plain Python and hold without a card, and the port's flash attention held
against the JAX package's kernel (interpret-mode Pallas) and its oracle at
the shapes that design takes (bf16, head_dim 64, 96, 128 and 256, GQA, ragged
and unequal lengths, the model layout). On the CPU the wrappers take the plain version;
the CUDA kernels are held against it on the card by ``chip_smoke.py``."""

import contextlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

CSRC = Path(fa.__file__).resolve().parent / "csrc"
TOL = 2e-2   # bf16: tests/test_kernels.py:70-71
HEADS = [(4, 4), (6, 2), (8, 2), (4, 1)]   # MHA, GQA 3:1, GQA 4:1, MQA
# The head_dim-128 instance (granite, qwen3, llama3, arctic, llama4) at GQA
# 4:1 and 7:1, the head_dim-96 one (phi3_mini, MHA) at MHA and GQA 4:1 and
# the head_dim-256 one (paligemma, MQA) at MQA and GQA 4:1, beside HEADS at
# head_dim 64: (h, kv, d), the old cases keeping their ids.
NEW_HEADS_BY_D = [(8, 2, 128), (7, 1, 128), (4, 4, 96), (8, 2, 96),
                  (4, 1, 256), (8, 2, 256)]
HEADS_BY_D = [*(pytest.param(h, kv, 64, id=f"{h}-{kv}") for h, kv in HEADS),
              *(pytest.param(h, kv, d, id=f"{h}-{kv}-d{d}")
                for h, kv, d in NEW_HEADS_BY_D)]


def _bhsd(b, h, s, d=64, dtype=torch.bfloat16):
    return torch.zeros((b, h, s, d), dtype=dtype)


def _model_layout(b, h, s, d=64, dtype=torch.bfloat16):
    """A [B, H, S, D] view of a contiguous [B, S, H, D] tensor, as
    ``ops.flash_attention`` hands the model's tensors over."""
    return torch.zeros((b, s, h, d), dtype=dtype).transpose(1, 2)


LAYOUTS = {"bhsd": _bhsd, "model": _model_layout}


@pytest.mark.parametrize("d", fa.WGMMA_HEAD_DIMS)
@pytest.mark.parametrize("h,kv", HEADS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_predicate_takes_bf16_head_dims_64_and_128_in_both_layouts(layout, h, kv, d):
    mk = LAYOUTS[layout]
    q, k, v = mk(2, h, 300, d), mk(2, kv, 300, d), mk(2, kv, 300, d)
    assert fa.wgmma_eligible(q, k, v)


def test_wgmma_head_dims_are_the_kernels_instances():
    assert fa.WGMMA_HEAD_DIMS == (64, 96, 128, 224, 256)


def _strided_last_dim():
    return torch.zeros((1, 4, 96, 128), dtype=torch.bfloat16)[..., ::2]


def _misaligned():
    """A storage offset of one element: the base is 2 bytes off 16."""
    return torch.zeros(1 + 4 * 96 * 64, dtype=torch.bfloat16)[1:].view(1, 4, 96, 64)


def _row_stride_off_16():
    """Rows 68 elements (136 bytes) apart: not a multiple of 16 bytes."""
    return torch.zeros((1, 4, 96, 68), dtype=torch.bfloat16)[..., :64]


@pytest.mark.parametrize("case,make_q", [
    ("f32", lambda: _bhsd(1, 4, 96, dtype=torch.float32)),
    ("d16", lambda: _bhsd(1, 4, 96, 16)),
    ("d32", lambda: _bhsd(1, 4, 96, 32)),
    ("d80", lambda: _bhsd(1, 4, 96, 80)),
    ("d192", lambda: _bhsd(1, 4, 96, 192)),
    ("f32 d96", lambda: _bhsd(1, 4, 96, 96, dtype=torch.float32)),
    ("f32 d128", lambda: _bhsd(1, 4, 96, 128, dtype=torch.float32)),
    ("f32 d256", lambda: _bhsd(1, 4, 96, 256, dtype=torch.float32)),
    ("last-dim stride 2", _strided_last_dim),
    ("storage offset", _misaligned),
    ("row stride 136 bytes", _row_stride_off_16),
])
def test_predicate_sends_the_rest_to_the_first_kernel(case, make_q):
    q = make_q()
    d = q.shape[-1]
    kv = _bhsd(1, 2, 96, d, q.dtype)
    assert not fa.wgmma_eligible(q, kv, kv)
    assert fa.wgmma_eligible(*(_bhsd(1, n, 96) for n in (4, 2, 2)))


@pytest.mark.parametrize("which", ["k", "v"])
def test_predicate_looks_at_k_and_v_too(which):
    q, k, v = _bhsd(1, 4, 96), _bhsd(1, 2, 96), _bhsd(1, 2, 96)
    bad = _misaligned()[:, :2]
    args = (q, bad, v) if which == "k" else (q, k, bad)
    assert not fa.wgmma_eligible(*args)


def test_size_one_dims_do_not_disqualify():
    # Batch 1 and one kv head: their strides are never stepped.
    q = _model_layout(1, 4, 96)
    kv = torch.zeros((1, 96, 1, 64), dtype=torch.bfloat16).transpose(1, 2)
    assert fa.wgmma_eligible(q, kv, kv)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_tma_geometry_is_the_tensors_own_strides(layout):
    b, h, s, d = 3, 5, 7, 64
    t = LAYOUTS[layout](b, h, s)
    dims, strides = fa.tma_geometry(t)[:4], fa.tma_geometry(t)[4:]
    assert dims == [d, h, s, b]
    es = t.element_size()
    assert strides == [t.stride(1) * es, t.stride(2) * es, t.stride(0) * es]
    want = {"bhsd": [s * d * 2, d * 2, h * s * d * 2],
            "model": [d * 2, h * d * 2, s * h * d * 2]}[layout]
    assert strides == want
    assert all(x % 16 == 0 for x in strides)


def test_tma_geometry_gives_size_one_dims_a_legal_stride():
    t = torch.zeros((1, 96, 1, 64), dtype=torch.bfloat16).transpose(1, 2)
    geom = fa.tma_geometry(t)
    assert geom[:4] == [64, 1, 96, 1]
    assert geom[4] == 128 and geom[6] == 128      # H and B: one row
    assert geom[5] == t.stride(2) * 2              # S: the tensor's own


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_output_takes_the_callers_layout(layout):
    # The wrapper allocates the output with torch.empty_like(q): for a dense
    # q it keeps q's strides, so the model layout is written in place and
    # the output is TMA-describable too.
    q = LAYOUTS[layout](2, 4, 96)
    out = torch.empty_like(q)
    assert out.stride() == q.stride()
    assert fa.tma_describable(out)


@pytest.mark.parametrize("entry", ["flash_attention_wgmma", "flash_attention_fma",
                                   "flash_attention_cuda"])
def test_card_entries_reject_cpu_tensors(entry):
    q, kv = _bhsd(1, 4, 96), _bhsd(1, 2, 96)
    before = (fa.launches, fa.wgmma_launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(fa, entry)(q, kv, kv, causal=True)
    assert (fa.launches, fa.wgmma_launches) == before


def test_wgmma_source_uses_tma_ring_and_wgmma_for_both_products():
    src = (CSRC / "flash_attention_wgmma.cu").read_text()
    hdr = (CSRC / "hopper.cuh").read_text()
    assert '#include "hopper.cuh"' in src
    for ptx in ("wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16",
                "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16",
                "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16",
                "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16",
                "cp.async.bulk.tensor.4d.shared::cluster.global",
                "cp.async.bulk.tensor.4d.global.shared::cta",
                "mbarrier.try_wait.parity", "setmaxnreg.dec", "setmaxnreg.inc"):
        assert ptx in hdr, ptx
    for call in ("wgmma_m64n128k16_ss(", "wgmma_m64n64k16_ss(",
                 "wgmma_m64n64k16_rs_tb(", "wgmma_m64n96k16_rs_tb(",
                 "wgmma_m64n128k16_rs_tb(", "wgmma_m64n256k16_rs_tb(", "tma_load_4d(", "tma_store_4d(",
                 "setmaxnreg_dec<", "setmaxnreg_inc<", "mbar_wait(empty"):
        assert call in src, call
    # O += P V at N = 128: the register-A form with B transposed.
    rs128 = hdr.split("void wgmma_m64n128k16_rs_tb(")[1].split("\n}\n")[0]
    assert "m64n128k16.f32.bf16.bf16" in rs128
    assert "{%64, %65, %66, %67}, %68, p, 1, 1, 1;" in rs128
    # ... and at N = 96 and 256 (D = 96 and 256); Q K^T at N = 64 with both
    # operands K-major (D = 256's 64-row kv tiles).
    rs96 = hdr.split("void wgmma_m64n96k16_rs_tb(")[1].split("\n}\n")[0]
    assert "m64n96k16.f32.bf16.bf16" in rs96
    assert "{%48, %49, %50, %51}, %52, p, 1, 1, 1;" in rs96
    rs256 = hdr.split("void wgmma_m64n256k16_rs_tb(")[1].split("\n}\n")[0]
    assert "m64n256k16.f32.bf16.bf16" in rs256
    assert "{%128, %129, %130, %131}, %132, p, 1, 1, 1;" in rs256
    ss64 = hdr.split("void wgmma_m64n64k16_ss(")[1].split("\n}\n")[0]
    assert "%32, %33, p, 1, 1, 0, 0;" in ss64
    # One template, an instance at each head_dim the predicate sends.
    assert "template <int D>\n__global__" in src
    for d in fa.WGMMA_HEAD_DIMS:
        assert f"launch<{d}>(" in src, d
    # The tiles: ceil(D / 64) atoms (D = 96: two, the second half filled
    # and zeroed by TMA; D = 224: four, the fourth half filled); 64-row kv
    # tiles at four atoms (D = 224 and 256), whose O goes out through the q
    # tile.
    assert "static constexpr int ATOMS = (D + ATOM - 1) / ATOM;" in src
    assert "static constexpr int BK = ATOMS == 4 ? 64 : 128;" in src
    assert "static constexpr bool O_IN_Q = ATOMS == 4;" in src
    rs224 = hdr.split("void wgmma_m64n224k16_rs_tb(")[1].split("\n}\n")[0]
    assert "m64n224k16.f32.bf16.bf16" in rs224
    assert "{%112, %113, %114, %115}, %116, p, 1, 1, 1;" in rs224
    assert "SMEM_BYTES <= 232448" in src
    # At D = 128 P goes into P V as two bf16 terms (hi and the rest).
    assert "static constexpr bool P_HI_LO = D == 128;" in src
    assert src.count("wgmma_pv<D>(o, ") == 2
    # A box is one 128-byte swizzle atom wide, whatever D.
    assert "const cuuint32_t box[4] = {(cuuint32_t)ATOM, 1, box_s, 1};" in src
    assert "constexpr int STAGES = " in src
    stages = int(src.split("constexpr int STAGES = ")[1].split(";")[0])
    assert stages >= 2


def test_d96_ab_rewrites_the_committed_source():
    # flash_d96_ab.py builds the D = 96 instance's n128 route from a text
    # rewrite of the source; every piece it rewrites must be there once.
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import flash_d96_ab

    src = (CSRC / "flash_attention_wgmma.cu").read_text()
    out = flash_d96_ab.n128_source(src)
    assert "wgmma_m64n96k16_rs_tb(" not in out
    assert out.count(flash_d96_ab.N128) == 3


def _c_params(src, name):
    """The parameter list of the C entry ``name`` in ``src``."""
    sig = src.split(f'extern "C" int {name}(')[1].split(")")[0]
    return [" ".join(p.split()) for p in sig.split(",")]


@pytest.mark.parametrize("d,want", [(64, "fa_wgmma_forward"),
                                    (128, "fa_wgmma_forward"),
                                    (96, "fa_wgmma_forward"),
                                    (256, "fa_wgmma_forward"),
                                    (80, "fa_forward"), (192, "fa_forward")])
def test_card_route_hands_the_head_dim_to_the_entry(monkeypatch, d, want):
    # The C entry the card would run, recorded instead of launched: the
    # tensors are made to pass for CUDA ones, so only the predicate decides,
    # and the wgmma entry is typed as its C signature and given d.
    calls = []

    def entry(source, name, argtypes):
        def fn(*args):
            calls.append((source, name, argtypes, args))
            return 0
        return fn

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(fa._build, "entry", entry)
    monkeypatch.setattr(fa._build, "on_device", lambda t: contextlib.nullcontext())
    monkeypatch.setattr(fa._build, "stream", lambda t: 0)
    monkeypatch.setattr(fa, "launches", 0)
    monkeypatch.setattr(fa, "wgmma_launches", 0)
    q, kv = _model_layout(2, 8, 200, d), _model_layout(2, 2, 200, d)
    fa.flash_attention_cuda(q, kv, kv, causal=False)
    [(source, name, argtypes, args)] = calls
    assert name == want
    wgmma = want == "fa_wgmma_forward"
    assert (fa.launches, fa.wgmma_launches) == (1, int(wgmma))
    if wgmma:
        params = _c_params((CSRC / f"{source}.cu").read_text(), name)
        assert len(params) == len(argtypes) == len(args)
        assert params[10] == "int d" and args[10] == d
        assert args[5:10] == (2, 8, 2, 200, 200)          # B, H, Hkv, Sq, Sk
        assert args[11] == pytest.approx(d ** -0.5) and args[12] == 0


# ---- against the JAX package, at the wgmma design's shapes -----------------

def _pair(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _model_inputs(rng, b, sq, sk, h, kv, d=64):
    qj, qt = _pair(rng, (b, sq, h, d))
    kj, kt = _pair(rng, (b, sk, kv, d))
    vj, vt = _pair(rng, (b, sk, kv, d))
    return (qj, kj, vj), (qt, kt, vt)


def _hold_against_jax(jax_in, torch_in, causal, bq, bk):
    qj, kj, vj = jax_in
    got = ops.flash_attention(*torch_in, causal=causal)
    assert got.shape == torch_in[0].shape and got.dtype == torch.bfloat16
    pallas = jops.flash_attention(qj, kj, vj, causal=causal, bq=bq, bk=bk)
    oracle = jref.attention_ref(qj.swapaxes(1, 2), kj.swapaxes(1, 2),
                                vj.swapaxes(1, 2), causal=causal).swapaxes(1, 2)
    np.testing.assert_allclose(_np(got), _np(pallas), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(got), _np(oracle), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kv,d", HEADS_BY_D)
def test_model_layout_matches_jax_kernel_at_the_wgmma_tile(rng, h, kv, d, causal):
    # S = 256 at 128-row tiles: the interpret-mode Pallas kernel runs.
    jax_in, torch_in = _model_inputs(rng, 1, 256, 256, h, kv, d)
    before = fa.launches
    _hold_against_jax(jax_in, torch_in, causal, 128, 128)
    assert fa.launches == before   # the CPU path launches no kernel


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [96, 300])
@pytest.mark.parametrize("h,kv,d", [
    *(pytest.param(h, kv, 64, id=f"{h}-{kv}") for h, kv in [(6, 2), (4, 1)]),
    *(pytest.param(h, kv, d, id=f"{h}-{kv}-d{d}") for h, kv, d in NEW_HEADS_BY_D)])
def test_ragged_lengths_match_jax(rng, h, kv, d, s, causal):
    # No multiple of the tiles: the JAX side takes its oracle path.
    jax_in, torch_in = _model_inputs(rng, 2, s, s, h, kv, d)
    _hold_against_jax(jax_in, torch_in, causal, 128, 128)


@pytest.mark.parametrize("causal", [True, False])
def test_unequal_lengths_match_jax_kernel(rng, causal):
    # Sq 128 against Sk 320 (top-left aligned when causal), as chip_smoke
    # holds the kernel; the Pallas kernel runs at bq 128, bk 64.
    jax_in, torch_in = _model_inputs(rng, 1, 128, 320, 6, 2)
    _hold_against_jax(jax_in, torch_in, causal, 128, 64)
