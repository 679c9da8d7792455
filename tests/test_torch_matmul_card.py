"""relic_matmul's three designs and its gated form on the card against
their plain versions, each call's design read from the wgmma counters; a
4096^3 product and a gated one each run one device kernel. Run on the card:
``JAX_PLATFORMS=cpu PYTHONPATH=src python -m pytest -m card tests``. No JAX:
``test_torch_matmul_hopper.py`` checks ``CASES`` on the CPU."""

import zlib

import pytest
import torch

from card_holds import DT, card, hold, one_kernel  # noqa: F401
from repro_torch.kernels import ops
from repro_torch.kernels import relic_matmul as rm

F32, BF16 = torch.float32, torch.bfloat16
# relic_matmul: f32 rtol 2e-4 / atol 1e-2 (tests/test_kernels.py:35-37); bf16
# rtol 2e-2 / atol 2e-1, tighter than the tests' 2e-1 / 10. The gated form:
# rtol 2e-2, atol 2e-2 in f32 and 2.0 in bf16 (tests/test_kernels.py:48-50).
MM_TOL = {F32: (2e-4, 1e-2), BF16: (2e-2, 2e-1)}
GATED_TOL = {F32: (2e-2, 2e-2), BF16: (2e-2, 2.0)}
# (m, n, k) of x [m, k] @ w [k, n]: tests/test_kernels.py:24-29 (the last
# ragged, on mma.sync in bf16), then ragged bf16 shapes the wgmma design
# takes (M, N or K no multiple of its tiles, K and N multiples of 8), among
# them relic_tiny's down product; each with either output type.
MM_TEST_SHAPES = [(128, 128, 128), (256, 384, 512), (512, 256, 1024),
                  (100, 60, 36)]
MM_WGMMA_RAGGED = [(300, 264, 200), (2048, 768, 2048), (130, 136, 72)]
# The timed products: the quickstart's, relic_tiny's MLP products at 2048
# tokens and a square one in both types.
MM_TIMED = [(128, 128, 256, F32), (2048, 2048, 768, BF16),
            (2048, 768, 2048, BF16), (4096, 4096, 4096, BF16),
            (4096, 4096, 4096, F32)]
GATED_TEST = (256, 128, 256)    # tests/test_kernels.py:42-46
GATED_MLP = (2048, 2048, 768)   # relic_tiny's act(x@Wg)*(x@Wu) at 2048 tokens
ONE_KERNEL = {"mm": "mm-4096x4096x4096-bf16",
              "gated": "gated-2048x2048x768-bf16-silu"}


def _cases():
    """name -> (entry, (m, n, k), dtype, out dtype or None, act or None, the
    design that must run: "wgmma" for bf16 with K and N multiples of 8, else
    "mma.sync" (bf16) or "fma" (f32)). Entries: "mm" relic_matmul_cuda,
    "gated" relic_matmul_gated_cuda, "ops" ops.matmul."""
    cases = {}

    def add(entry, m, n, k, dtype, out=None, act=None):
        name = "-".join([entry, f"{m}x{n}x{k}", DT[dtype],
                         *([f"out_{DT[out]}"] if out else []),
                         *([act] if act else [])])
        design = ("fma" if dtype == F32 else
                  "wgmma" if k % 8 == 0 and n % 8 == 0 else "mma.sync")
        cases.setdefault(name, (entry, (m, n, k), dtype, out, act, design))

    for m, n, k, dtype in ([(*s, dt) for s in MM_TEST_SHAPES for dt in (F32, BF16)]
                           + [(*s, BF16) for s in MM_WGMMA_RAGGED]):
        add("mm", m, n, k, dtype)
        add("mm", m, n, k, dtype, out=F32 if dtype == BF16 else BF16)
    for m, n, k, dtype in MM_TIMED:
        add("mm", m, n, k, dtype)
    for m, n, k, dtype in [(*GATED_TEST, F32), (*GATED_TEST, BF16)] + [
            (*s, BF16) for s in (*MM_WGMMA_RAGGED, (100, 60, 36), GATED_MLP)]:
        for act in ("silu", "gelu", "none"):   # "none": no activation
            add("gated", m, n, k, dtype, act=act)
    add("ops", 100, 60, 36, F32)   # ops.matmul keeps no tile predicate
    return cases


CASES = _cases()


def case_inputs(name, device="cpu"):
    """Seeded x [m, k] and the weights [k, n] of one case (two for the
    gated form)."""
    entry, (m, n, k), dtype, *_ = CASES[name]
    g = torch.Generator(device=device).manual_seed(zlib.crc32(name.encode()))

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=device).to(dtype)

    return rnd(m, k), [rnd(k, n) for _ in range(2 if entry == "gated" else 1)]


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CASES))
def test_design_runs_and_is_the_plain_version(card, name):
    entry, _, dtype, out, act, design = CASES[name]
    x, ws = case_inputs(name, card)
    gated = entry == "gated"
    counters = ("gated_launches", "gated_wgmma_launches") if gated else (
        "launches", "wgmma_launches")
    before = [getattr(rm, c) for c in counters]
    if gated:
        got, want = (rm.relic_matmul_gated_cuda(x, *ws, act=act),
                     rm.relic_matmul_gated_plain(x, *ws, act))
    else:
        got = (ops.matmul(x, ws[0], bm=128, bn=128, bk=128) if entry == "ops"
               else rm.relic_matmul_cuda(x, ws[0], out_dtype=out))
        want = rm.relic_matmul_plain(x, ws[0], out)
    torch.cuda.synchronize()
    assert [getattr(rm, c) - b for c, b in zip(counters, before)] == [
        1, int(design == "wgmma")]
    hold(got, want, *(GATED_TOL[dtype] if gated else MM_TOL[out or dtype]))


def one_kernel_call(entry):
    x, ws = case_inputs(ONE_KERNEL[entry], torch.device("cuda"))
    if entry == "gated":
        return lambda: rm.relic_matmul_gated_cuda(x, *ws, act="silu")
    return lambda: rm.relic_matmul_cuda(x, ws[0])


@pytest.mark.card
@pytest.mark.parametrize("entry", sorted(ONE_KERNEL))
def test_one_call_is_one_kernel(card, entry):
    one_kernel(__name__, entry, "mm_wgmma_kernel")
