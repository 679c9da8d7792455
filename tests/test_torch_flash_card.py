"""Flash attention's two designs on the card against the plain version,
each call's design read from ``fa.wgmma_launches``, and one call at [4,
2048] that runs one device kernel. Run on the card: ``JAX_PLATFORMS=cpu
PYTHONPATH=src python -m pytest -m card tests``. No JAX: ``test_torch_flash_hopper.py`` checks
``CASES`` on the CPU."""

import zlib

import pytest
import torch

from card_holds import DT, card, hold, one_kernel  # noqa: F401
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

F32, BF16 = torch.float32, torch.bfloat16
TOL = {F32: 2e-4, BF16: 2e-2}   # rtol = atol: tests/test_kernels.py:70-71
# The entries a case calls; "ops" takes the model layout [B, S, H, D].
ENTRIES = {"fma": fa.flash_attention_fma, "wgmma": fa.flash_attention_wgmma,
           "cuda": fa.flash_attention_cuda, "ops": ops.flash_attention}
# (b, s, h, kv, d) of tests/test_kernels.py:55-60; the wgmma design on MHA,
# GQA and MQA at lengths no multiple of its 128-row tiles and Sq 128 against
# Sk 320; head sizes beyond 64 (48 on the next instance up, 320 and 512 in
# slabs of 128 columns) and the kernel table's [2, 8, 1024, d].
KERNEL_SHAPES = [(2, 128, 4, 4, 32), (1, 256, 8, 2, 64), (2, 128, 8, 1, 32),
                 (1, 96, 4, 2, 16)]
WGMMA_HEADS, WGMMA_LENGTHS = [(4, 4), (12, 4), (8, 2), (8, 1)], (96, 300, 1000)
WIDE_SHAPES = {128: [(2, 200, 4, 4), (2, 200, 8, 2), (2, 200, 7, 1),
                     (1, 1000, 8, 2)],
               96: [(2, 200, 4, 4), (2, 200, 8, 2), (1, 1000, 8, 2)],
               256: [(2, 200, 8, 1), (2, 200, 8, 2), (1, 1000, 8, 1)]}
FMA_HEAD_DIMS = (48, 96, 256, 320, 512)
# flash_attention_cuda's dispatch at (1, 96, 4, 2, d): (dtype, d, design).
DISPATCH = [*((BF16, d, "wgmma") for d in fa.WGMMA_HEAD_DIMS),
            *((F32, d, "fma") for d in fa.WGMMA_HEAD_DIMS),
            (BF16, 32, "fma"), (BF16, 80, "fma")]
# The models' attention on the wgmma design: name -> ((b, s, h, kv, d),
# causal, sk): the [8, 192] teacher-forced forwards, zamba2_1p2b's shared
# attention, granite's heads at [4, 2048], whisper's three and relic_tiny's
# long forward.
PATHS = {"relic_tiny": ((8, 192, 12, 4, 64), True, None),
         "zamba2_1p2b": ((8, 256, 32, 32, 64), True, None),
         "granite_8b": ((8, 192, 32, 8, 128), True, None),
         "arctic_480b": ((8, 192, 56, 8, 128), True, None),
         "qwen3_14b": ((8, 192, 40, 8, 128), True, None),
         "llama3_405b": ((8, 192, 128, 8, 128), True, None),
         "long_d128": ((4, 2048, 32, 8, 128), True, None),
         "phi3_mini_3p8b": ((8, 192, 32, 32, 96), True, None),
         "paligemma_3b": ((8, 192, 8, 1, 256), True, None),
         "whisper_encoder": ((8, 1500, 20, 20, 64), False, None),
         "whisper_cross": ((8, 192, 20, 20, 64), False, 1500),
         "whisper_decoder": ((8, 192, 20, 20, 64), True, None),
         "relic_tiny_long": ((4, 2048, 12, 4, 64), True, None)}
ONE_KERNEL = "ops-b4s2048h12kv4d64-bf16-causal"   # relic_tiny at [4, 2048]


def _cases():
    """name -> (entry, (b, s, h, kv, d), dtype, causal, sk or None, the
    design that must run: "wgmma" or "fma")."""
    cases = {}

    def add(entry, shape, dtype, causal, sk=None, design="wgmma", name=None):
        b, s, h, kv, d = shape
        name = name or (f"{entry}-b{b}s{s}{f'sk{sk}' if sk else ''}h{h}kv{kv}"
                        f"d{d}-{DT[dtype]}-{'causal' if causal else 'full'}")
        assert name not in cases, name
        cases[name] = (entry, shape, dtype, causal, sk, design)

    for causal in (True, False):
        for shape in KERNEL_SHAPES:
            for dtype in (F32, BF16):
                add("fma", shape, dtype, causal, design="fma")
        for h, kv in WGMMA_HEADS:
            for s in WGMMA_LENGTHS:
                add("wgmma", (2, s, h, kv, 64), BF16, causal)
        for d, shapes in WIDE_SHAPES.items():
            for b, s, h, kv in shapes:
                add("wgmma", (b, s, h, kv, d), BF16, causal)
            add("wgmma", (2, 128, 8, 2, d), BF16, causal, sk=320)
        for d in FMA_HEAD_DIMS:
            for dtype in (F32, BF16):
                add("fma", (2, 200, 8, 2, d), dtype, causal, design="fma")
        for d in fa.WGMMA_HEAD_DIMS:
            for s in (96, 300):
                add("ops", (1, s, 4, 2, d), BF16, causal)
    add("wgmma", (2, 128, 12, 4, 64), BF16, False, sk=320)
    for dtype, d, design in DISPATCH:
        add("cuda", (1, 96, 4, 2, d), dtype, True, design=design)
    for d in set(FMA_HEAD_DIMS) & set(fa.WGMMA_HEAD_DIMS):
        add("wgmma", (2, 1024, 8, 2, d), BF16, True)
    for path, (shape, causal, sk) in PATHS.items():
        add("wgmma", shape, BF16, causal, sk, name=f"path-{path}")
    add("ops", PATHS["relic_tiny_long"][0], BF16, True)
    return cases


CASES = _cases()


def case_inputs(name, device="cpu"):
    """Seeded q, k, v of one case: [B, H, S, D] and [B, Kv, Sk, D], or the
    model layout [B, S, H, D] for ``ops.flash_attention``."""
    entry, (b, s, h, kv, d), dtype, _, sk, _ = CASES[name]
    g = torch.Generator(device=device).manual_seed(zlib.crc32(name.encode()))

    def rnd(heads, length):
        shape = (b, length, heads, d) if entry == "ops" else (b, heads, length, d)
        return torch.randn(shape, generator=g, device=device).to(dtype)

    return rnd(h, s), rnd(kv, sk or s), rnd(kv, sk or s)


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CASES))
def test_design_runs_and_is_the_plain_version(card, name):
    entry, _, dtype, causal, _, design = CASES[name]
    q, k, v = case_inputs(name, card)
    before = (fa.launches, fa.wgmma_launches)
    got = ENTRIES[entry](q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert (fa.launches - before[0], fa.wgmma_launches - before[1]) == (
        1, int(design == "wgmma"))
    if entry == "ops":   # the plain version in [B, H, S, D]
        q, k, v, got = (t.transpose(1, 2) for t in (q, k, v, got))
    hold(got, fa.flash_attention_plain(q, k, v, causal=causal), TOL[dtype],
         TOL[dtype])


def one_kernel_call(name):
    q, k, v = case_inputs(name, torch.device("cuda"))
    return lambda: ops.flash_attention(q, k, v, causal=True)


@pytest.mark.card
def test_one_call_in_the_model_layout_is_one_kernel(card):
    one_kernel(__name__, ONE_KERNEL, "fa_wgmma_kernel")
