"""The conv kernel (``repro_torch.kernels.conv``, ``csrc/conv.cu``) on the
card: bit for bit ``_causal_conv`` on every case, in f32 and bf16, one
launch a call, among them zamba2_7b's cell shape read from a strided view of
the in-projection's output; what it refuses, before any launch; and one
launch a Mamba layer in a Zamba2-7B-Instruct forward at its published width
and depth. Skips where there is no card; run on the card: ``PYTHONPATH=src
python -m pytest -m card tests/test_torch_conv_card.py``.

``CASES`` and ``case_inputs`` serve the CPU tests too
(``tests/test_torch_conv.py``), so this file imports no JAX."""

import json
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import conv, ops
from repro_torch.models.mamba2 import _causal_conv

ROOT = Path(__file__).resolve().parents[1]
# name -> (B, S, C, in-projection width, xBC's first column, K, bias): x is
# the view [:, :, col:col + C] of a [B, S, width] tensor, as ``_split_in``
# cuts xBC from the in-projection's output (width C and column 0: x is
# contiguous). zamba2_7b's cell: 4 x 4096 tokens, C = 7168 + 2 * 2 * 64 with
# its bias; zamba2_1p2b's C = 4096 + 2 * 64, no bias; at the CPU tests'
# smoke width, d_inner 128 and 8 heads, xBC in 2 groups of state 16 (C 192)
# and in one (C 160): fewer tokens than taps, lengths that are no multiple
# of the kernel's run of 16 tokens or of its step of 4, one row, and fewer
# taps.
CASES = {
    "zamba2_7b": (4, 4096, 7424, 14704, 7168, 4, True),
    "zamba2_1p2b": (2, 1024, 4224, 8384, 4096, 4, False),
    "short": (2, 2, 192, 328, 128, 4, True),
    "ragged": (2, 103, 192, 328, 128, 4, True),
    "one_row": (1, 300, 160, 296, 128, 4, False),
    "taps_1": (2, 77, 192, 192, 0, 1, True),
    "taps_2": (2, 77, 160, 160, 0, 2, False),
    "taps_3": (3, 70, 192, 328, 128, 3, True),
}
SMALL = [n for n in CASES if not n.startswith("zamba2")]


def case_inputs(name, dtype, device="cpu", bias=None):
    """Seeded x [B, S, C] (a view where the case cuts one), w [K, C] and
    bias [C], or None; ``bias`` True or False overrides the case's."""
    b, s, c, width, col, k, has_bias = CASES[name]
    g = torch.Generator(device=device).manual_seed(sum(map(ord, name)))

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=device)).to(dtype)

    x = rnd(b, s, width)[:, :, col:col + c]
    w = rnd(k, c, scale=0.5)
    keep = has_bias if bias is None else bias
    return x, w, (rnd(c, scale=0.1) if keep else None)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card: PYTHONPATH=src python "
                    "-m pytest -m card tests/test_torch_conv_card.py")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_is_causal_conv_bit_for_bit(card, name, dtype):
    x, w, bias = case_inputs(name, dtype, card)
    before = conv.launches
    got = ops.causal_conv_silu(x, w, bias)
    torch.cuda.synchronize()
    assert conv.launches == before + 1
    assert got.dtype == dtype and got.is_contiguous() and got.shape == x.shape
    assert torch.equal(got, _causal_conv(x, w, None, bias)[0])


def _bad(name, card):
    x, w, bias = case_inputs("ragged", torch.bfloat16, card)
    if name == "float16":
        return x.half(), w.half(), bias.half()
    if name == "five_taps":
        return x, torch.cat([w, w[:1]]), bias
    if name == "misaligned":     # C and the base one channel off 8 bytes
        return x[..., 1:], w[:, 1:].contiguous(), bias[1:].contiguous()
    return x, w, bias


@pytest.mark.card
@pytest.mark.parametrize("bad", ["float16", "five_taps", "misaligned"])
def test_kernel_refuses_before_any_launch(card, bad):
    x, w, bias = _bad(bad, card)
    before = conv.launches
    with pytest.raises(ValueError, match="causal_conv_silu takes"):
        ops.causal_conv_silu(x, w, bias)
    assert conv.launches == before


@pytest.mark.card
def test_kernel_refuses_a_gradient_and_a_dtensor(card):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch.dryrun import fake_group

    x, w, bias = case_inputs("ragged", torch.float32, card)
    before = conv.launches
    with pytest.raises(RuntimeError, match="use_kernels=False"):
        ops.causal_conv_silu(x, w.requires_grad_(True), bias)
    w.requires_grad_(False)
    with fake_group(1):
        mesh = init_device_mesh(card.type, (1,))
        dx = DTensor.from_local(x, mesh, [Replicate()], run_check=False)
        with pytest.raises(RuntimeError, match="takes no DTensor"):
            ops.causal_conv_silu(dx, w, bias)
    assert conv.launches == before


@pytest.mark.card
def test_published_forward_launches_once_a_mamba_layer(card):
    from portbench.harness import program
    from portbench.reference import zamba2 as ref

    doc = json.loads((ROOT / "portbench" / "configs" / "zamba2_7b.json").read_text())
    m = {**doc["model"], **doc["serve"]}
    model, params, flat, _ = program.build(m, ref, 2**31 + 7, card, False,
                                           doc["init_rules"])
    toks = torch.randint(0, m["vocab_size"], (2, 1024), device=card,
                         generator=torch.Generator(device=card).manual_seed(2))
    conv.launches = 0
    with torch.no_grad():
        logits, _ = model.forward(params, toks)
    torch.cuda.synchronize()
    assert conv.launches == m["n_layers"] == 81
    assert torch.isfinite(logits).all()
    del model, params, flat, logits
    torch.cuda.empty_cache()
