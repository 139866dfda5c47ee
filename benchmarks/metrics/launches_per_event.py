"""Kernel launches an event (vapor_tpu_torch.engine.kernels.LAUNCHES,
summed over the nine hand kernels)."""


def read(run):
    if not run.trace or not run.events or run.launches is None:
        return None
    return run.launches / run.events
