"""Peak device memory allocated over the window (``torch.cuda.max_memory_allocated``
after ``reset_peak_memory_stats`` at its start), GiB."""

from readers import GIB


def read(m):
    return m.peak_bytes / GIB if m.peak_bytes else None
