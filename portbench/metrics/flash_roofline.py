"""flash_roofline: the least time the card could take for the attention
calls of the traced stretch, over the summed device time of the port's
flash kernels there (by kernel name). Each call's work is the cell's
shape (every call of a cell has the same): the kept causal pairs' two
products against the bf16 peak, q, k, v read and o written once against
the memory rate (``work/flash.py``, ``peaks.json``)."""

import re
import sys

from portbench.harness.spec import PKG, load_json
from portbench.work.flash import attention_work

NAME = "flash_roofline"
KERNELS = re.compile(r"\bfa_(wgmma_kernel|fwd_kernel|fwd_slab_kernel)\b")


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
    hd = m["head_dim"] or m["d_model"] // m["n_heads"]
    flops, nbytes = attention_work(mix["batch"], m["n_heads"], m["n_kv_heads"],
                                   mix["length"], mix["length"], hd, True, 2)
    peaks = load_json(PKG / "peaks.json")
    bound = max(flops / peaks["flops_per_s"], nbytes / peaks["bytes_per_s"])
    return 100.0 * launches * bound / seconds
