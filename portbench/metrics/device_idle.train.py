"""device_idle.train: the share of the traced stretch in which no kernel,
copy or memset ran on the card (1 - the union of their intervals over the
stretch)."""


def read(run):
    t = run.traced
    if t is None or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
