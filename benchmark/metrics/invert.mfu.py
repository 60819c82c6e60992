"""The inversion's model FLOPs over the window's time, as a share of the dense bf16 peak."""

from readers import mfu


def read(m):
    return mfu(m, "invert")
