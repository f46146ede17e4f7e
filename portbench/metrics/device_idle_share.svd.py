"""Share of the traced half of the window (to the last video in host
memory) in which no kernel or copy ran on the card, in percent."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
