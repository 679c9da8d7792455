"""score_tokens_per_s: every token scored in the window over the window's
time (host clock, closed by the last batch's sums on the host)."""


def read(run):
    return run.window.tokens / run.window.seconds
