"""conv_roofline: the least time the card could take for the conv calls of
the traced stretch, over the summed device time of the port's conv kernel
there (by kernel name). Each call's work is the cell's shape: x [batch,
length, C] with C = d_inner + 2 * groups * state, K taps and the bias where
the configuration has one, in the serving dtype (``work/conv.py``) against
``peaks.json``."""

import re
import sys

from portbench.harness.spec import PKG, load_json
from portbench.work.conv import conv_work

NAME = "conv_roofline"
KERNELS = re.compile(r"\bcausal_conv_silu_kernel\b")
ELEM_BYTES = {"bfloat16": 2, "float32": 4}


def read(run):
    if run.traced is None:
        return None
    launches, seconds = run.traced.kernel_time(KERNELS)
    if not launches:
        return None
    print(f"{NAME}: launches in the traced stretch "
          f"{run.traced.launches(KERNELS)}", file=sys.stderr)
    mix = run.cell.traffic
    m = run.cell.model(mix["layout"])
    s = m["ssm"]
    c = s["expand"] * m["d_model"] + 2 * s.get("n_groups", 1) * s["state_dim"]
    ops, nbytes = conv_work(mix["batch"], mix["length"], c, s["conv_kernel"],
                            ELEM_BYTES[m["compute_dtype"]],
                            bool(m.get("conv_bias")))
    peaks = load_json(PKG / "peaks.json")
    bound = max(ops / peaks["flops_per_s"], nbytes / peaks["bytes_per_s"])
    return 100.0 * launches * bound / seconds
