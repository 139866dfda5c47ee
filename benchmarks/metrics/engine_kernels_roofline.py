"""Share of the kernels' device time that a bound on bytes alone would
need: every haplotype and read byte handed to the scorers and to the
window refiner once, plus one 8-byte score per (read, haplotype), at the
card's HBM bandwidth (peaks.json), over the device time of every CUDA
kernel of the traced window.  In %."""
from benchmarks import roofline


def read(run):
    return roofline.share_pct(run.bytes_bound,
                              run.device.get("kernel_s", 0.0), run.peaks)
