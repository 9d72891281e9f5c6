"""Meshes of ranks over ``torch.distributed`` (``launch/mesh.py``)."""
