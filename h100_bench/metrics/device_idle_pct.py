"""Device: the share of the traced epoch with no kernel, copy or memset
running on the card, %."""


def read(ctx):
    if not ctx.window_s or not ctx.activities:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
