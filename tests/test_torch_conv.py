"""The conv wrapper (``ops.causal_conv_silu``, ``kernels/conv.py``) on the
CPU: its plain route is ``_causal_conv`` with no launch, with and without a
bias, at one and two groups of B and C; it refuses a gradient, a DTensor
and a shape it cannot take on every device; its card entry refuses before
any build or launch, and each condition of the kernel's is named when a
tensor misses it; the Mamba-2 block under ``use_kernels`` sends its conv
through the wrapper and gives the same output as through ``_causal_conv``.
The kernel itself is held on the card by ``tests/test_torch_conv_card.py``
on the same cases."""

import json
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import conv, ops
from repro_torch.models import mamba2 as m2
from repro_torch.models.zamba2 import Zamba2Config

import test_torch_conv_card as conv_card

DOC = json.loads((Path(__file__).resolve().parents[1] / "portbench" / "configs"
                  / "zamba2_7b.json").read_text())


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("name", ["ragged", "one_row"], ids=["G2", "G1"])
def test_plain_route_is_causal_conv(name, bias):
    x, w, b = conv_card.case_inputs(name, torch.bfloat16, bias=bias)
    before = conv.launches
    got = ops.causal_conv_silu(x, w, b)
    assert conv.launches == before
    assert got.dtype == x.dtype and got.is_contiguous() and got.shape == x.shape
    assert torch.equal(got, m2._causal_conv(x, w, None, b)[0])


def _refusing_entry(*a, **k):
    raise AssertionError("the kernel was built or launched")


@pytest.mark.parametrize("bad", ["cpu", "float16", "five_taps", "misaligned"])
def test_card_entry_refuses_before_any_launch(bad, monkeypatch):
    # On the CPU every refusal of the card entry is the device, first; what
    # the card checks next refuses f16, five taps and a base or a C off 8
    # bytes.
    monkeypatch.setattr(conv._build, "entry", _refusing_entry)
    x, w, bias = conv_card._bad(bad, "cpu")
    before = conv.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        conv.causal_conv_silu_cuda(x, w, bias)
    assert (conv._card_refusal(x, w, bias) is None) == (bad == "cpu")
    assert conv.launches == before


def _cut(width, col, c, dtype=torch.bfloat16):
    """x [2, 103, c] cut from a [2, 103, width] tensor at column ``col``,
    with w [4, c] and bias [c]."""
    g = torch.Generator().manual_seed(width + col + c)
    full = torch.randn((2, 103, width), generator=g).to(dtype)
    return (full[:, :, col:col + c], torch.randn((4, c), generator=g).to(dtype),
            torch.randn((c,), generator=g).to(dtype))


def _missing(name):
    x, w, bias = _cut(328, 128, 192)
    if name == "float32":
        return x.float(), w.float(), bias.float()
    if name == "float16":
        return x.half(), w.half(), bias.half()
    if name == "w_dtype":
        return x, w.float(), bias
    if name == "bias_dtype":
        return x, w, bias.float()
    if name == "five_taps":
        return x, torch.cat([w, w[:1]]), bias
    if name == "empty":
        return x[:, :0], w, bias
    if name == "channels_strided":
        return x[..., ::2], w[:, ::2].contiguous(), bias[::2].contiguous()
    if name == "w_strided":
        return x, w.t().contiguous().t(), bias
    if name == "bias_strided":
        return x, w, torch.stack([bias, bias], 1)[:, 0]
    if name == "base":
        return _cut(328, 129, 192)
    if name == "channels":
        return _cut(328, 128, 190)
    if name == "row_stride":
        return _cut(330, 128, 192)
    return x, w, bias


@pytest.mark.parametrize("name, why", [
    ("bfloat16", None), ("float32", None),
    ("float16", "all float32 or all bfloat16"),
    ("w_dtype", "all float32 or all bfloat16"),
    ("bias_dtype", "all float32 or all bfloat16"),
    ("five_taps", "at most 4 taps"), ("empty", "no empty input"),
    ("channels_strided", "8-byte access"), ("w_strided", "8-byte access"),
    ("bias_strided", "8-byte access"), ("base", "8-byte access"),
    ("channels", "8-byte access"), ("row_stride", "8-byte access")])
def test_card_refusal_names_each_condition(name, why):
    # The kernel's conditions read shapes, strides and addresses alone, so
    # the CPU holds them: the card entry raises with this text.
    got = conv._card_refusal(*_missing(name))
    assert got is None if why is None else why in got


@pytest.mark.parametrize("bad", ["x_2d", "w_channels", "bias_shape", "no_taps"])
def test_wrapper_refuses_a_shape_it_cannot_take(bad):
    x, w, bias = conv_card.case_inputs("ragged", torch.float32)
    if bad == "x_2d":
        x = x[0]
    elif bad == "w_channels":
        w = w[:, :-8]
    elif bad == "bias_shape":
        bias = bias[:-1]
    else:
        w = w[:0]
    with pytest.raises(ValueError, match="are not|is not"):
        ops.causal_conv_silu(x, w, bias)


def test_wrapper_refuses_a_dtensor():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch.dryrun import fake_group

    x, w, bias = conv_card.case_inputs("ragged", torch.float32)
    with fake_group(1):
        mesh = init_device_mesh("cpu", (1,))
        dx = DTensor.from_local(x, mesh, [Replicate()], run_check=False)
        with pytest.raises(RuntimeError, match="takes no DTensor"):
            ops.causal_conv_silu(dx, w, bias)


def test_wrapper_refuses_a_gradient():
    x, w, bias = conv_card.case_inputs("ragged", torch.float32)
    with pytest.raises(RuntimeError, match="use_kernels=False"):
        ops.causal_conv_silu(x, w, bias.requires_grad_(True))
    with torch.no_grad():   # the same call outside autograd runs
        got = ops.causal_conv_silu(x, w, bias)
    assert got.grad_fn is None


def _block(groups: int, bias: bool, kernels: bool):
    """zamba2_7b's smoke-size Mamba-2 block in bf16 with ``groups`` groups
    of B and C and the conv bias or not; its parameters and an input."""
    m = {**DOC["model"], **DOC["smoke"], "param_dtype": "bfloat16",
         "compute_dtype": "bfloat16", "use_kernels": kernels,
         "conv_bias": bias, "ssm": {**DOC["smoke"]["ssm"], "n_groups": groups}}
    cfg = Zamba2Config.from_dict({k: v for k, v in m.items() if k != "type"})
    gen = torch.Generator().manual_seed(7 + groups)
    p = m2.init_mamba2(cfg, gen, "cpu")
    x = torch.randn((2, 100, cfg.d_model), generator=gen).bfloat16()
    return cfg, p, x


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("groups", [1, 2])
def test_block_under_use_kernels_is_the_same_through_the_wrapper(
        groups, bias, monkeypatch):
    cfg, p, x = _block(groups, bias, kernels=True)
    assert m2._groups(cfg) == groups and ("conv_bias" in p) == bias
    calls = []
    wrapper = ops.causal_conv_silu

    def counted(*args):
        calls.append(args)
        return wrapper(*args)

    with torch.no_grad():
        monkeypatch.setattr(ops, "causal_conv_silu", counted)
        routed = m2.mamba2_block(cfg, p, x)    # the kernel's route, plain version
        monkeypatch.setattr(ops, "causal_conv_silu",
                            lambda xbc, w, b=None: m2._causal_conv(xbc, w, None, b)[0])
        plain = m2.mamba2_block(cfg, p, x)     # _causal_conv, as without the kernel
    assert len(calls) == 1 and calls[0][0].shape[-1] == m2._dims(cfg)[2]
    assert torch.equal(routed, plain)
