"""wkv6's and ssd's two designs each on the card against their plain
versions, each call's design read from ``tc_launches``; one ``ops.wkv6``
call in the model's layout runs one device kernel. Run on the card:
``JAX_PLATFORMS=cpu PYTHONPATH=src python -m pytest -m card tests``. No JAX:
``test_torch_ssd_hopper.py`` checks ``CASES`` on the CPU."""

import zlib

import pytest
import torch

from card_holds import DT, card, hold, one_kernel  # noqa: F401
from repro_torch.kernels import ops
from repro_torch.kernels import ssd as ssd_k
from repro_torch.kernels import wkv6 as wkv6_k

F32, BF16 = torch.float32, torch.bfloat16
# f32 rtol = atol = 1e-3, bf16 rtol 2e-2 / atol 2e-1
# (tests/test_kernels.py:88-93,108-111).
REC_TOL = {F32: (1e-3, 1e-3), BF16: (2e-2, 2e-1)}
KERNELS = {"wkv6": wkv6_k, "ssd": ssd_k}
# (b, h, t, k | p, n, chunk): tests/test_kernels.py:75-79 and 97-100, then
# the tensor-core designs at ragged T and odd H, and sizes of 6 (the first
# designs, padded to 8); each in f32 and bf16.
TEST_SHAPES = {"wkv6": [(2, 2, 64, 16, 16), (1, 4, 128, 32, 32),
                        (2, 2, 96, 16, 32), (2, 4, 96, 64, 64),
                        (1, 3, 45, 64, 64), (2, 2, 300, 64, 64),
                        (2, 3, 7, 64, 64), (1, 2, 37, 6, 16)],
               "ssd": [(2, 2, 64, 16, 8, 16), (1, 4, 128, 32, 16, 32),
                       (2, 4, 200, 64, 64, 128), (1, 3, 45, 64, 64, 32),
                       (2, 5, 77, 64, 64, 128), (1, 2, 45, 6, 6, 32)]}
# The served forwards (rwkv6_1p6b in bf16 at [8, 192], zamba2_1p2b in f32 at
# [8, 256]) and a long one of each at [4, 2048].
MAIN = {"wkv6": (BF16, {"served": (8, 32, 192, 64, 64),
                        "long": (4, 32, 2048, 64, 64)}),
        "ssd": (F32, {"served": (8, 64, 256, 64, 64, 128),
                      "long": (4, 64, 2048, 64, 64, 128)})}


def _cases():
    """name -> (kernel, shape ending with the chunk, dtype, whether the
    tensor-core design must run: wkv6 at K = 64, ssd in f32 at P = N = 64)."""
    cases = {}
    for kernel in KERNELS:
        named = [(f"{kernel}-{'x'.join(map(str, s))}-{DT[dt]}", s, dt)
                 for s in TEST_SHAPES[kernel] for dt in (F32, BF16)]
        dtype, shapes = MAIN[kernel]
        named += [(f"{kernel}-{label}", s, dtype) for label, s in shapes.items()]
        for name, shape, dt in named:
            tc = shape[3] == 64 and (kernel == "wkv6" or (
                dt == F32 and shape[4] == 64))
            cases[name] = (kernel, shape, dt, tc)
    return cases


CASES = _cases()


def wkv6_inputs(g, b, h, t, k, dtype, device):
    """r, k, v [b, h, t, k] in ``dtype``; f32 logw with the aggressive
    decays of tests/test_kernels.py:84, and u [h, k]."""
    def rnd(*shape):
        return torch.randn(shape, generator=g, device=device)
    r, kk, v = (rnd(b, h, t, k).to(dtype) for _ in range(3))
    return r, kk, v, -torch.exp(rnd(b, h, t, k)), rnd(h, k)


def case_inputs(name, device="cpu"):
    """Seeded inputs of one case in the kernel's [B, H, T, ...] layout: wkv6
    as ``wkv6_inputs``; ssd x [b, h, t, p] in the dtype, f32 a [b, h, t] and
    b, c [b, t, n]."""
    kernel, (*shape, _), dtype, _ = CASES[name]
    g = torch.Generator(device=device).manual_seed(zlib.crc32(name.encode()))
    if kernel == "wkv6":
        return wkv6_inputs(g, *shape, dtype, device)
    b, h, t, p, n = shape
    x = torch.randn((b, h, t, p), generator=g, device=device).to(dtype)
    a = -torch.randn((b, h, t), generator=g, device=device).abs() * 0.5
    return (x, a, *(torch.randn((b, t, n), generator=g, device=device)
                    for _ in range(2)))


def tc_eligible(kernel, ins) -> bool:
    """The wrapper's own predicate on a case's inputs."""
    if kernel == "wkv6":
        return wkv6_k.tc_eligible(ins[0])
    return ssd_k.tc_eligible(ins[0], ins[2])


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CASES))
def test_design_runs_and_is_the_plain_version(card, name):
    kernel, shape, dtype, tc = CASES[name]
    mod, ins = KERNELS[kernel], case_inputs(name, card)
    assert tc_eligible(kernel, ins) == tc
    before = (mod.launches, mod.tc_launches)
    got = getattr(mod, f"{kernel}_cuda")(*ins, chunk=shape[-1])
    torch.cuda.synchronize()
    assert (mod.launches - before[0], mod.tc_launches - before[1]) == (1, int(tc))
    hold(got, getattr(mod, f"{kernel}_plain")(*ins), *REC_TOL[dtype])


def _model_layout(device):
    """wkv6's inputs, and r, k, v and logw in the model's [B, T, H, K]."""
    g = torch.Generator(device=device).manual_seed(4)
    ins = wkv6_inputs(g, 2, 3, 70, 64, BF16, device)
    return ins, [x.transpose(1, 2).contiguous() for x in ins[:4]]


def one_kernel_call(device):
    (*_, u), model = _model_layout(device)
    return lambda: ops.wkv6(*model, u, chunk=64)


@pytest.mark.card
def test_wkv6_in_the_model_layout_is_one_kernel(card):
    ins, model = _model_layout(card)
    before = wkv6_k.tc_launches
    got = ops.wkv6(*model, ins[4], chunk=64)
    assert wkv6_k.tc_launches == before + 1
    hold(got, wkv6_k.wkv6_plain(*ins).transpose(1, 2), *REC_TOL[BF16])
    one_kernel(__name__, "cuda", "wkv6_tc_kernel")
