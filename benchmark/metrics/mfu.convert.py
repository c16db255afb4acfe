"""mfu.convert: the window's conversion passes as a share (%) of the card's peak, the encoder and decoder at the peak of their dtype, the frontend and Griffin-Lim at float32's."""

from benchmark.core import readers


def read(r):
    return readers.mfu(r)
