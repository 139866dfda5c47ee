"""Events validated and written by the window's completed CLI calls,
over the time from the window's start to the end of the last one."""


def read(run):
    if run.window_s <= 0:
        return None
    return run.events / run.window_s
