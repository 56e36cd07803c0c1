"""Kernels: B7's share of its roofline over the traced epoch, %
(``kernels/b7.json``; ``readers.roofline``)."""
from h100_bench.readers import roofline


def read(ctx):
    return roofline(ctx, "b7")
