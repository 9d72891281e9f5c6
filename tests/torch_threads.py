"""Caps torch's intra-op thread pool for the port's tests that run a model.

Import it (``import torch_threads  # noqa: F401``) after
``pytest.importorskip("torch")``. The suite runs in several xdist
workers on one machine, and torch's default pool is as wide as the
machine in each of them: the pools then fight over the cores (one test
took ~3 s alone and 525 s beside five busy workers). The cap is
process-wide, so it also reaches the service's worker threads.
"""
import torch

torch.set_num_threads(2)
