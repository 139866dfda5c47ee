"""Device ms an event of the rdd route's kernels (``kept_hist``,
``rdd_moment`` and ``intercept_z``) in the traced window (torch.profiler,
benchmarks/roofline.py)."""
from benchmarks import roofline

RDD_KERNELS = ("kept_hist", "rdd_moment", "intercept_z")


def read(run):
    return roofline.route_ms_per_event(run, RDD_KERNELS)
