"""Hand-written Hopper kernels of the port (CUDA C++ under ``csrc/``,
built at first use by ``build.py``), their plain PyTorch versions
(``ref.py``) and the dispatching wrappers (``ops.py``)."""
