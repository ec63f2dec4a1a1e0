"""k1_roofline.batch: K1 (the encoder's self-attention) in the traced
call, percent of its roofline at the shapes it was launched with."""

from benchmark.metrics._kernel import roofline
from benchmark.rooflines import k1


def read(rec):
    return roofline(rec, "k1", k1)
