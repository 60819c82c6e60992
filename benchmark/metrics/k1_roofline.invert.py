"""K1 (flash_fwd) in the inversion cells: its calls' least time over its traced device time."""

from readers import roofline


def read(m):
    return roofline(m, "invert", "flash_fwd")
