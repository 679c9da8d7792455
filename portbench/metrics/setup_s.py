"""setup_s: seconds from the process's start to the first timed item
(imports, the card's context, the weights, warming every shape the cell
uses; in a checkout's first run, the kernels' build)."""


def read(run):
    return run.setup_s
