"""ssd_roofline: the least time the card could take for the SSD calls of
the traced stretch, over the summed device time of the port's ssd kernels
there (by kernel name). Each call's work is the cell's shape: the chunked
scan's operations, exponentials included, against the bf16 peak, x, a and
each group's b and c read and y written once against the memory rate
(``work/ssd.py``, ``peaks.json``)."""

import re
import sys

from portbench.harness.spec import PKG, load_json
from portbench.work.ssd import ssd_work

NAME = "ssd_roofline"
KERNELS = re.compile(r"\bssd(_tc)?_kernel\b")


def read(run):
    if run.traced is None:
        return None
    launches, seconds = run.traced.kernel_time(KERNELS)
    if not launches:
        return None
    print(f"{NAME}: launches in the traced stretch "
          f"{run.traced.launches(KERNELS)}", file=sys.stderr)
    mix = run.cell.traffic
    s = run.cell.model(mix["layout"])["ssm"]
    heads = s["expand"] * run.cell.model(mix["layout"])["d_model"] // s["head_dim"]
    prods, rest, exps, nbytes = ssd_work(
        mix["batch"], heads, mix["length"], s["head_dim"], s["state_dim"],
        s["chunk"], groups=s.get("n_groups", 1))
    peaks = load_json(PKG / "peaks.json")
    bound = max((prods + rest + exps) / peaks["flops_per_s"],
                nbytes / peaks["bytes_per_s"])
    return 100.0 * launches * bound / seconds
