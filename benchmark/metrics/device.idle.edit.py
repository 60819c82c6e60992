"""The share of the traced edit window in which the device ran nothing."""

from readers import idle


def read(m):
    return idle(m, "edit")
