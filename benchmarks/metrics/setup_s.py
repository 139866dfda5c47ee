"""Seconds from the harness's start to the window's: imports, the
inputs drawn from the seed, the kernel build (first run of a checkout)
and the warm-up call."""


def read(run):
    return run.setup_s
