"""1 - the union of device activity over the traced window, as a
fraction of the window."""


def read(run):
    if "busy_s" not in run.device or run.window_s <= 0:
        return None
    return 1.0 - run.device["busy_s"] / run.window_s
