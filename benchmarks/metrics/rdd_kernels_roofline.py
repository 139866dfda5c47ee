"""Share of the rdd route's kernel time (``kept_hist``, ``rdd_moment``,
``intercept_z``) that the route's own bytes need at the card's HBM
bandwidth: the haplotype and read bytes of the rows scored through
redefine_diagonal, plus one 8-byte score a (read, haplotype), once each
(benchmarks/spans.py's ``bytes_by_route["rdd"]``).  In %."""
from benchmarks import roofline

RDD_KERNELS = ("kept_hist", "rdd_moment", "intercept_z")


def read(run):
    return roofline.route_roofline(run, "rdd", RDD_KERNELS)
