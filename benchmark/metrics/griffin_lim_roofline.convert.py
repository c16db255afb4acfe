"""griffin_lim_roofline.convert: kernel 4's share (%) of its roofline over the traced passes."""

from benchmark.core import readers


def read(r):
    return readers.roofline(r, "griffin_lim")
