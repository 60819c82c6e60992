"""Seconds per inversion step: the window's time over the inversion steps it completed."""

from readers import step_s


def read(m):
    return step_s(m, "invert")
