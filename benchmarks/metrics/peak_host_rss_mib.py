"""Largest resident set of the run's process over the window (its peak
reset when the window opens)."""


def read(run):
    return run.rss_mib if run.rss_mib > 0 else None
