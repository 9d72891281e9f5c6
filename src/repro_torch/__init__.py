"""PyTorch + CUDA port of the LLM compression system (``repro``).

The JAX package ``repro`` stays the reference; this package imports
nothing of it (nor JAX) and keeps its own copies of the host-side
modules. Entry points run on the card unless the caller passes
``device="cpu"``.
"""
