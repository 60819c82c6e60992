"""The edit's model FLOPs (the yardstick's count: convolutions, linear layers, attention products, match similarities) over the window's time, as a share of the dense bf16 peak."""

from readers import mfu


def read(m):
    return mfu(m, "edit")
