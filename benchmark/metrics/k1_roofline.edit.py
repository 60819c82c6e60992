"""K1 (flash_fwd) in the edit cells: its calls' least time over its traced device time."""

from readers import roofline


def read(m):
    return roofline(m, "edit", "flash_fwd")
