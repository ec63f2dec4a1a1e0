"""k2_roofline.batch: K2 (the decode step's int8 cross-attention) in the
traced call, percent of its roofline at the shapes it was launched with."""

from benchmark.metrics._kernel import roofline
from benchmark.rooflines import k2


def read(rec):
    return roofline(rec, "k2", k2)
