"""train_tokens_per_s: every token of every train step issued in the
window over the window's time, which closes when the card has finished
them (host clock)."""


def read(run):
    return run.window.tokens / run.window.seconds
