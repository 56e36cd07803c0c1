"""Kernels: B6's share of its roofline over the traced epoch, %
(``kernels/b6.json``; ``readers.roofline``)."""
from h100_bench.readers import roofline


def read(ctx):
    return roofline(ctx, "b6")
