"""relic_matmul's designs on the card, as far as they hold without one: the
dispatch predicate and the tile choices (plain Python), the shape of the
CUDA sources, and the plain version held against the JAX package's kernel
(interpret-mode Pallas) and oracle at the ragged shapes the wgmma design
takes. The CUDA kernels themselves are held against the plain version on
the card by ``tests/test_torch_matmul_card.py``, whose cases are checked
here first."""

import ast
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from portbench.work.flash import attention_work
from portbench.work.ssd import ssd_work
from repro_torch.kernels import ops
from repro_torch.kernels import relic_matmul as rm

import test_torch_matmul_card as mm_card

CSRC = Path(rm.__file__).resolve().parent / "csrc"
ROOT = Path(__file__).resolve().parents[1]
H100_SMS = 132


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("m,n,k", [(128, 128, 128), (300, 264, 200),
                                   (2048, 768, 2048), (130, 136, 72), (1, 8, 8)])
def test_predicate_takes_bf16_that_tma_can_describe(m, n, k):
    assert rm.wgmma_eligible(_bf16(m, k), _bf16(k, n))


def _misaligned(rows, cols):
    """A storage offset of one element: the base is 2 bytes off 16."""
    return torch.zeros(1 + rows * cols, dtype=torch.bfloat16)[1:].view(rows, cols)


@pytest.mark.parametrize("case,make", [
    ("f32", lambda: (torch.zeros(128, 64), torch.zeros(64, 128))),
    ("K % 8 != 0", lambda: (_bf16(100, 36), _bf16(36, 64))),
    ("N % 8 != 0", lambda: (_bf16(100, 64), _bf16(64, 60))),
    ("x misaligned", lambda: (_misaligned(64, 64), _bf16(64, 64))),
    ("w misaligned", lambda: (_bf16(64, 64), _misaligned(64, 64))),
    ("x a transposed view", lambda: (_bf16(64, 128).t(), _bf16(64, 64))),
    ("w a column slice", lambda: (_bf16(64, 64), _bf16(64, 136)[:, :64])),
])
def test_predicate_sends_the_rest_to_the_other_kernels(case, make):
    x, w = make()
    assert not rm.wgmma_eligible(x, w)


@pytest.mark.parametrize("m,n,want", [
    (2048, 2048, 256),   # relic_tiny's up product: 128 tiles, one round either way
    (2048, 768, 128),    # its down product: 96 tiles of 128 in one round, not 48 of 256
    (4096, 4096, 256),
    (300, 264, 128),
    (128, 128, 128),     # one tile either way: the narrower does less work
])
def test_wgmma_tile_width_by_shape(m, n, want):
    assert rm.wgmma_tile_n(m, n, H100_SMS) == want


@pytest.mark.parametrize("m,n", [(1, 8), (300, 264), (2048, 768), (8192, 4096)])
def test_wgmma_tile_width_is_an_instance(m, n):
    assert rm.wgmma_tile_n(m, n, H100_SMS) in rm.WGMMA_TILES_N


def _f32_ctas(m, n):
    bm, bn = rm.F32_TILES[rm.f32_tile(m, n, H100_SMS)]
    return -(-m // bm) * -(-n // bn)


def test_quickstart_f32_product_spreads_over_at_least_16_ctas():
    # examples/quickstart.py:64-66: [128, 256] @ [256, 128] in f32; one
    # 128 x 128 tile would put it on one SM of 132.
    assert _f32_ctas(128, 128) >= 16
    assert rm.F32_TILES[rm.f32_tile(128, 128, H100_SMS)] == (16, 32)


@pytest.mark.parametrize("m,n,want", [
    (4096, 4096, (128, 128)),
    (2048, 2048, (128, 128)),
    (128, 128, (16, 32)),
    (100, 60, (16, 32)),
])
def test_f32_tile_by_shape(m, n, want):
    assert rm.F32_TILES[rm.f32_tile(m, n, H100_SMS)] == want


@pytest.mark.parametrize("m,n", [(4096, 4096), (512, 512), (64, 64), (1, 1)])
def test_f32_tile_fills_the_card_when_any_tile_can(m, n):
    ctas = _f32_ctas(m, n)
    smallest = -(-m // rm.F32_TILES[-1][0]) * -(-n // rm.F32_TILES[-1][1])
    assert ctas >= H100_SMS or ctas == smallest


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_entry_rejects_cpu_tensors_before_any_design(dtype):
    x, w = torch.zeros(128, 64, dtype=dtype), torch.zeros(64, 128, dtype=dtype)
    before = (rm.launches, rm.wgmma_launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rm.relic_matmul_cuda(x, w)
    assert (rm.launches, rm.wgmma_launches) == before


def test_wgmma_source_is_a_tma_ring_feeding_wgmma_with_b_transposed():
    src = (CSRC / "relic_matmul_wgmma.cu").read_text()
    hdr = (CSRC / "hopper.cuh").read_text()
    assert '#include "hopper.cuh"' in src
    for ptx in ("cp.async.bulk.tensor.2d.shared::cluster.global",
                "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16",
                "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16",
                "mbarrier.try_wait.parity", "setmaxnreg.dec"):
        assert ptx in hdr, ptx
    # The transpose bit of B (the last immediate) in the SS helpers.
    for name in ("wgmma_m64n256k16_ss_tb", "wgmma_m64n128k16_ss_tb"):
        body = hdr.split(f"void {name}(")[1].split("\n}\n")[0]
        assert "p, 1, 1, 0, 1;" in body, name
    for call in ("tma_load_2d(", "wgmma_m64n256k16_ss_tb(", "wgmma_m64n128k16_ss_tb(",
                 "mbar_wait(empty", "mbar_wait(full", "mbar_arrive(empty",
                 "setmaxnreg_dec<", "setmaxnreg_inc<", "kStages<BN, GATED>"):
        assert call in src, call


def test_f32_source_stays_ieee_on_a_cp_async_ring():
    src = (CSRC / "relic_matmul.cu").read_text()
    assert "cp.async.cg.shared.global" in src and "cp.async.wait_group" in src
    assert ".tf32" not in src and "cvt.rna.tf32" not in src   # never TF32
    assert "atomic" not in src         # no split of K by atomics


def test_chip_smoke_builds_every_source():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    sources = next(ast.literal_eval(node.value) for node in tree.body
                   if isinstance(node, ast.Assign)
                   and any(getattr(t, "id", None) == "SOURCES" for t in node.targets))
    assert sorted(sources) == sorted(p.stem for p in CSRC.glob("*.cu"))


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _least_ms(t_ops, t_bytes):
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


@pytest.mark.parametrize("b,s,h,kv,d,sk,causal,dtype", [
    (8, 192, 32, 32, 96, 192, True, torch.bfloat16),     # phi3's [8, 192]
    (8, 192, 20, 20, 64, 1500, False, torch.bfloat16),   # whisper's cross
    (1, 96, 4, 2, 16, 96, True, torch.float32)])         # ragged, GQA
def test_chip_smoke_attention_bound_is_the_benchmarks_work(cs, b, s, h, kv, d,
                                                            sk, causal, dtype):
    # chip_smoke.py's attention bound: portbench/work's count over its own
    # peaks.
    q, k = _meta(b, h, s, d, dtype=dtype), _meta(b, kv, sk, d, dtype=dtype)
    flops, nbytes = attention_work(b, h, kv, s, sk, d, causal, q.element_size())
    want = _least_ms(flops / cs.PEAK_FLOPS[dtype], nbytes / cs.PEAK_BYTES_S)
    assert cs.attention_bound_ms(q, k, causal) == (*want, flops, nbytes)


@pytest.mark.parametrize("b,h,t,p,n,g,chunk", [
    (4, 112, 4096, 64, 64, 2, 256),   # zamba2_7b's grouped Mamba layer
    (8, 64, 256, 64, 64, 1, 128),     # zamba2_1p2b served
    (1, 3, 45, 64, 64, 1, 32)])       # ragged T, odd H
def test_chip_smoke_ssd_bounds_are_the_benchmarks_work(cs, b, h, t, p, n, g,
                                                       chunk):
    # chip_smoke.py's ssd bounds: portbench/work's count over its own
    # peaks, all on the f32 CUDA cores, then the products on 3xTF32.
    x = _meta(b, h, t, p)
    bmat = _meta(b, t, g, n) if g > 1 else _meta(b, t, n)
    prods, rest, exps, nbytes = ssd_work(b, h, t, p, n, chunk, 4, g)
    f32, t_bytes = cs.PEAK_FLOPS[torch.float32], nbytes / cs.PEAK_BYTES_S
    want = _least_ms((prods + rest + exps) / f32, t_bytes)
    want_tc = _least_ms(prods / (cs.PEAK_TF32 / 3) + (rest + exps) / f32, t_bytes)
    assert cs.ssd_bounds(x, bmat, chunk) == (*want, *want_tc, prods + rest,
                                             exps, nbytes)


def test_card_cases_take_the_design_they_name():
    # The card test's case table: every case valid for the wrapper, its
    # design the one the dispatch predicate and the dtype give.
    for name, (entry, (m, n, k), dtype, out, _, design) in mm_card.CASES.items():
        x, ws = mm_card.case_inputs(name)
        assert x.shape == (m, k) and all(w.shape == (k, n) for w in ws), name
        assert len(ws) == (2 if entry == "gated" else 1), name
        rm._check(entry, x, ws, out)
        assert all(rm.wgmma_eligible(x, w) for w in ws) == (design == "wgmma"), name
        assert (dtype == torch.float32) == (design == "fma"), name


# ---- against the JAX package, at the ragged shapes of the wgmma design ------

TOL = {"float32": 2e-4, "bfloat16": 2e-1}   # tests/test_kernels.py:20


def _pair(rng, shape, dtype):
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(
        getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,k", [
    (128, 256, 64), (256, 128, 64),        # the Pallas kernel's tiles divide these
    (300, 264, 200), (130, 136, 72),       # ragged: the JAX side takes its oracle
])
def test_ragged_shapes_match_jax(rng, dtype, m, n, k):
    xj, xt = _pair(rng, (m, k), dtype)
    yj, yt = _pair(rng, (k, n), dtype)
    before = (rm.launches, rm.wgmma_launches)
    got = ops.matmul(xt, yt, bm=128, bn=128, bk=64)
    assert (rm.launches, rm.wgmma_launches) == before   # no kernel on the CPU
    assert got.shape == (m, n) and got.dtype == xt.dtype
    tol = TOL[dtype]
    for want in (jops.matmul(xj, yj, bm=128, bn=128, bk=64), jref.matmul_ref(xj, yj)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol * 50)


# ---- the gated form on the wgmma ring ---------------------------------------

def _gated_inputs(case):
    m, n, k = 300, 264, 200
    return {
        "bf16 that TMA can describe": (_bf16(m, k), _bf16(k, n), _bf16(k, n)),
        "w_up misaligned": (_bf16(64, 64), _bf16(64, 64), _misaligned(64, 64)),
        "w_gate a column slice": (_bf16(64, 64), _bf16(64, 136)[:, :64], _bf16(64, 64)),
        "K % 8 != 0": (_bf16(100, 36), _bf16(36, 64), _bf16(36, 64)),
        "f32": (torch.zeros(m, k), torch.zeros(k, n), torch.zeros(k, n)),
    }[case]


@pytest.mark.parametrize("case,want", [
    ("bf16 that TMA can describe", "relic_matmul_gated_wgmma_forward"),
    ("w_up misaligned", "relic_matmul_gated_forward"),
    ("w_gate a column slice", "relic_matmul_gated_forward"),
    ("K % 8 != 0", "relic_matmul_gated_forward"),
    ("f32", "relic_matmul_gated_forward"),
])
def test_gated_route_is_taken_by_wgmma_eligible(monkeypatch, case, want):
    # The C entry the card would run, recorded instead of launched: the
    # tensors are made to pass for CUDA ones, so only the predicate decides.
    x, wg, wu = _gated_inputs(case)
    calls = []

    def record(source, entry, argtypes, x, weights, out_dtype, *ints):
        calls.append((source, entry, ints))
        return torch.empty(0)

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(rm, "_launch", record)
    monkeypatch.setattr(rm, "sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(rm, "gated_launches", 0)
    monkeypatch.setattr(rm, "gated_wgmma_launches", 0)
    rm.relic_matmul_gated_cuda(x, wg, wu, act="gelu")
    assert [c[1] for c in calls] == [want]
    wgmma = want == "relic_matmul_gated_wgmma_forward"
    assert (rm.gated_launches, rm.gated_wgmma_launches) == (1, int(wgmma))
    assert wgmma == (rm.wgmma_eligible(x, wg) and rm.wgmma_eligible(x, wu))
    if wgmma:
        source, _, (out_bf16, m, n, k, bn, act) = calls[0]
        assert source == "relic_matmul_wgmma" and (m, n, k) == (300, 264, 200)
        assert bn in rm.GATED_WGMMA_TILES_N and act == rm.ACTS["gelu"] and out_bf16 == 1


@pytest.mark.parametrize("m,n,want", [
    (2048, 2048, 128),   # relic_tiny's gate/up at 2048 tokens: 2 rounds of 128 or 4 of 64
    (2048, 768, 128),
    (128, 128, 64),      # one round either way: the narrower does less work
])
def test_gated_tile_width_by_shape(m, n, want):
    assert rm.wgmma_tile_n(m, n, H100_SMS, rm.GATED_WGMMA_TILES_N) == want


def test_gated_source_has_two_accumulators_on_one_ring():
    src = (CSRC / "relic_matmul_wgmma.cu").read_text()
    assert "template <int BN, bool GATED>" in src
    assert "constexpr int NW = GATED ? 2 : 1;" in src
    assert "float acc[NW][BN / 2];" in src          # one accumulator per weight
    # One ring: one pair of barrier arrays, one expect_tx for all of a
    # stage's tiles, both weights' wgmmas on the same x stage.
    assert src.count("mbar_arrive_expect_tx(") == 1
    assert "A_BYTES + NW * atoms * ATOM_BYTES" in src
    assert src.count("uint64_t* full =") == 1 and src.count("uint64_t* empty =") == 1
    assert "wgmma_tile<BN>(acc[w], desc_a + 2 * kk," in src
    assert "activate(act, v0) * acc[NW - 1]" in src
    assert 'extern "C" int relic_matmul_gated_wgmma_forward(' in src
    assert "float activate(" in (CSRC / "hopper.cuh").read_text()
    assert "float activate(" not in (CSRC / "relic_matmul.cu").read_text()


GATED_ATOL = {"float32": 2e-2, "bfloat16": 2.0}   # tests/test_kernels.py:48-50


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,k", [
    (128, 256, 64),                     # the Pallas kernel's tiles divide these
    (300, 264, 200), (130, 136, 72),    # ragged: the JAX side takes its oracle
])
def test_gated_ragged_shapes_match_jax(rng, act, dtype, m, n, k):
    xj, xt = _pair(rng, (m, k), dtype)
    gj, gt = _pair(rng, (k, n), dtype)
    uj, ut = _pair(rng, (k, n), dtype)
    before = (rm.gated_launches, rm.gated_wgmma_launches)
    got = ops.matmul_gated(xt, gt, ut, act=act, bm=128, bn=128, bk=64)
    assert (rm.gated_launches, rm.gated_wgmma_launches) == before   # no kernel on the CPU
    assert got.shape == (m, n) and got.dtype == xt.dtype
    for want in (jops.matmul_gated(xj, gj, uj, act=act, bm=128, bn=128, bk=64),
                 jref.matmul_gated_ref(xj, gj, uj, act)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=GATED_ATOL[dtype])
