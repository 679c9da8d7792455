"""The conv work count against hand counts at two shapes, and the
``conv_roofline`` reader on a synthetic trace: the count at the zamba2_7b
cell's shape and at the port's hybrid's widths, and nothing where the
kernel is absent or the run was not traced."""

import types

import pytest

from portbench.harness.spec import PKG, Metric, load_json
from portbench.work.conv import conv_work


@pytest.mark.parametrize("args,want", [
    # zamba2_7b's cell: x [4, 4096, 7424] bf16, 4 taps and a bias: 13
    # operations an element; x and the output 2 * 121,634,816 elements,
    # the taps 4 * 7424 and the bias 7424, 2 bytes each
    ((4, 4096, 7424, 4, 2, True), (1581252608, 486613504)),
    # x [1, 3, 8] f32, 2 taps, no bias: 8 operations an element; 2 * 24 + 16
    ((1, 3, 8, 2, 4, False), (192, 256)),
])
def test_conv_work(args, want):
    assert conv_work(*args) == want


def _conv_run(launches, bias=True, traced=True):
    """A run of zamba2_7b's cell (or its port's hybrid's widths, one group
    and no bias) whose trace finds ``launches`` conv kernels in 0.25 s."""
    ssm = {"expand": 2, "state_dim": 64, "conv_kernel": 4}
    if bias:
        ssm["n_groups"] = 2
    model = {"d_model": 3584 if bias else 2048, "ssm": ssm,
             "compute_dtype": "bfloat16", "conv_bias": bias}
    found = {"causal_conv_silu_kernel": launches} if launches else {}
    trace = types.SimpleNamespace(kernel_time=lambda _: (launches, 0.25),
                                  launches=lambda _: found)
    cell = types.SimpleNamespace(traffic={"layout": "serve", "batch": 4,
                                          "length": 4096},
                                 model=lambda _: model)
    return types.SimpleNamespace(traced=trace if traced else None, cell=cell)


@pytest.mark.parametrize("bias,c", [(True, 7424), (False, 4224)])
def test_conv_roofline_reads_the_cell(bias, c):
    _, nbytes = conv_work(4, 4096, c, 4, 2, bias)
    bound = nbytes / load_json(PKG / "peaks.json")["bytes_per_s"]
    got = Metric("conv_roofline", "%").reader().read(_conv_run(486, bias))
    assert got == pytest.approx(100.0 * 486 * bound / 0.25)


@pytest.mark.parametrize("launches,traced", [(0, True), (486, False)])
def test_conv_roofline_reads_nothing_without_the_kernel(launches, traced):
    reader = Metric("conv_roofline", "%").reader()
    assert reader.read(_conv_run(launches, traced=traced)) is None
    assert reader.KERNELS.search(
        "void (anonymous namespace)::causal_conv_silu_kernel<(anonymous "
        "namespace)::BF16, 4>(...)")
    for other in ("void at::native::elementwise_kernel<128, 2>(...)",
                  "conv_depthwise2d_forward_kernel", "ssd_tc_kernel"):
        assert not reader.KERNELS.search(other)
