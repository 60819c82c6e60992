"""Device ms a step of the edit loop's pivotal pass (keyframes, extended attention)."""

from readers import pass_ms


def read(m):
    return pass_ms(m, "pivotal")
