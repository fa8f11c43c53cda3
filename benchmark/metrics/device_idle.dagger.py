"""The share of the profiled window in which no kernel, memcpy or memset
ran on the card, in %."""


def read(run):
    p = run.profile
    if p is None or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
