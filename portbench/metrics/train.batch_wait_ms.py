"""train.batch_wait_ms: the mean time a train step waited for its batch,
from the call to the pipeline's ``next_batch`` to the batch's copy on the
card being issued (the benchmark's span ``next_batch``), over the steps of
the window (host clock)."""


def read(run):
    waits = run.spans.durations("next_batch", run.window.t0, run.window.t1)
    return sum(waits) / len(waits) * 1e3 if waits else None
