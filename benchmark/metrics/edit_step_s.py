"""Seconds per edit step: the window's time over the edit steps it completed, both passes of every step and the host work between steps included."""

from readers import step_s


def read(m):
    return step_s(m, "edit")
