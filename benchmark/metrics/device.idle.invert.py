"""The share of the traced inversion window in which the device ran nothing."""

from readers import idle


def read(m):
    return idle(m, "invert")
