"""mfu.score: the closed-form model operations of the window's scoring
batches (``work/<flops>.py``) over the window's time, as a share of the
card's bf16 peak (``peaks.json``)."""

from portbench.harness.spec import PKG, load_json


def read(run):
    mix, w = run.cell.traffic, run.window
    flops = run.cell.work().forward_flops(run.cell.model(mix["layout"]),
                                          mix["batch"], mix["length"])
    peak = load_json(PKG / "peaks.json")["flops_per_s"]
    return 100.0 * flops * w.items / w.seconds / peak
