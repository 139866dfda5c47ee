"""Device ms an event of every CUDA kernel in the traced window
(torch.profiler; copies and memsets left out)."""


def read(run):
    if not run.events or "kernel_s" not in run.device:
        return None
    return 1e3 * run.device["kernel_s"] / run.events
