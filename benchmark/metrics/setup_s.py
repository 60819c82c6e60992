"""Seconds from the process's start to the first timed step: imports, the
kernel library, weights, models, inputs and the warm-up steps."""


def read(m):
    return m.setup_s
