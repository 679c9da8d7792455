"""The plain reference computes the port's function: its chunked SSD
against the step-by-step recurrence, its forward against the port's plain
paths at SMOKE sizes in float32 (weights from the same draw), and the
control's fp8 rounding."""

import dataclasses

import pytest
import torch

from portbench.harness import program
from portbench.reference import control, lm


def _naive_ssd(x, a, b, c):
    state = torch.zeros(x.shape[0], x.shape[2], x.shape[3], b.shape[-1],
                        dtype=torch.float64)
    ys = []
    for t in range(x.shape[1]):
        state = (state * torch.exp(a[:, t])[..., None, None]
                 + torch.einsum("bhp,bn->bhpn", x[:, t], b[:, t]))
        ys.append(torch.einsum("bhpn,bn->bhp", state, c[:, t]))
    return torch.stack(ys, 1)


@pytest.mark.parametrize("t,chunk", [(37, 8), (32, 32), (5, 16)])
def test_chunked_ssd_is_the_recurrence(t, chunk):
    g = torch.Generator().manual_seed(t)
    x = torch.randn(2, t, 3, 4, generator=g, dtype=torch.float64)
    a = -torch.rand(2, t, 3, generator=g, dtype=torch.float64)
    b = torch.randn(2, t, 5, generator=g, dtype=torch.float64)
    c = torch.randn(2, t, 5, generator=g, dtype=torch.float64)
    got = lm.ssd(x.float(), a.float(), b.float(), c.float(), chunk)
    torch.testing.assert_close(got.double(), _naive_ssd(x, a, b, c),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "phi3_mini_3p8b"])
def test_forward_is_the_ports_in_float32(arch):
    from repro_torch.configs import get_config

    m = {**dataclasses.asdict(get_config(arch, smoke=True)),
         "compute_dtype": "float32", "use_kernels": False}
    model, params, _, _ = program.build(m, lm, 2**31 + 3, "cpu", False)
    toks = torch.randint(0, m["vocab_size"], (2, 24),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, _ = model.forward(params, toks)
        _, w = program.reference_weights(m, lm, 2**31 + 3, "cpu")
        got = lm.forward(m, w, toks)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_fp8_rounds_to_three_mantissa_bits():
    t = torch.linspace(-3.0, 3.0, 1001)
    q = control.fp8(t)
    assert not torch.equal(q, t)
    big = t.abs() > 0.05
    assert ((q - t).abs()[big] <= t.abs()[big] * 2.0 ** -4 + 1e-7).all()
    assert q.unique().numel() < 300
