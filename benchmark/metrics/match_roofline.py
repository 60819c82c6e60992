"""K2/K3 (match_core) in the edit cells: the propagation matches' least time over their traced device time."""

from readers import roofline


def read(m):
    return roofline(m, "edit", "match_core")
