"""Device ms a step of the edit loop's propagation pass (all frames, token propagation)."""

from readers import pass_ms


def read(m):
    return pass_ms(m, "propagate")
