"""The sharding policy over a mesh (``sharding/specs.py``)."""
