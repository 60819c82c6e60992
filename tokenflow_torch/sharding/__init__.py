"""Frame-axis sharding over ``torch.distributed`` (``sharding/mesh.py``)."""
