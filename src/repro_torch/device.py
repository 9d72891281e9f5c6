"""Device selection shared by the port's entry points.

``ModelPredictor``, ``CompressionService`` and the ``llmc-torch`` CLI run
on the CUDA card unless the caller asks for the CPU (``device="cpu"``,
as the tests do). With no card and no explicit CPU request they raise:
they never carry on on the CPU by themselves.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` (None means ``"cuda"``) as a ``torch.device``; raises
    RuntimeError when a CUDA device is asked for and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the card unless "
            "the caller passes device='cpu'")
    return dev
