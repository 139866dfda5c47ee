"""Share of the kernels' device time that a bound on bytes alone would
need: every haplotype and read byte handed to the scorers and to the
window refiner once, plus one 8-byte score per (read, haplotype), at the
card's HBM bandwidth (peaks.json), over the device time of every CUDA
kernel of the traced window.  In %."""


def read(run):
    kernel_s = run.device.get("kernel_s", 0.0)
    if kernel_s <= 0 or run.bytes_bound <= 0:
        return None
    bound_s = run.bytes_bound / run.peaks["hbm_bytes_per_s"]
    return 100.0 * bound_s / kernel_s
