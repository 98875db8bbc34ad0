"""The share of the traced window in which no device activity ran, in %."""


def read(run):
    w = run.window
    if not w.device or w.window_s <= 0:
        return None
    return 100.0 * (1.0 - w.busy_s() / w.window_s)
