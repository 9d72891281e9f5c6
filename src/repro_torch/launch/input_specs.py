"""Meta-device stand-ins for every input of a step: the counterparts of
the JAX package's ``launch/input_specs.py`` (``ShapeDtypeStruct``s),
which the dry run (``launch/dryrun.py``) traces a step against.

Each is a tensor on the ``meta`` device (a shape and a dtype, no
storage) at the shape the port's step takes on one rank of ``mesh``:
the parameters and the decode cache at this rank's blocks
(``sharding.specs``), the optimizer state at the parameters' blocks,
and the batch whole (B, ...), as the port's steps take it and cut it
themselves (the train step its microbatches' rows, the serve and score
steps their lanes).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import api as model_api
from repro_torch.models.schema import schema
from repro_torch.models.transformer import torch_dtype
from repro_torch.sharding import specs

META = torch.device("meta")


def abstract_params(cfg: ModelConfig, mesh=None,
                    layout: str = "serve") -> dict:
    """Every parameter leaf as a meta tensor in the config's dtype, at
    this rank's block under ``layout`` on ``mesh`` (whole with no
    mesh)."""
    dtype = torch_dtype(cfg.dtype)
    ps = None if mesh is None else specs.param_pspecs(cfg, mesh, layout)

    def walk(tree, sp):
        out = {}
        for k in sorted(tree):      # init_params' order: its gathers'
            leaf = tree[k]
            if isinstance(leaf, dict):
                out[k] = walk(leaf, None if sp is None else sp[k])
                continue
            shape = tuple(leaf.shape) if sp is None else \
                specs.local_shape(mesh, sp[k], tuple(leaf.shape))
            out[k] = torch.empty(shape, dtype=dtype, device=META)
        return out
    return walk(schema(cfg), ps)


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The batch of a train or score step: tokens (B, S) int64 (vlm:
    the text's S - n_img and ``img_embeds`` (B, n_img, D); encdec:
    ``frames`` (B, max_source_len, D)), whole."""
    B, S = shape.global_batch, shape.seq_len
    dt = torch_dtype(cfg.dtype)
    if cfg.family == "vlm":
        n = cfg.n_img_tokens
        return {"tokens": torch.empty((B, S - n), dtype=torch.int64,
                                      device=META),
                "img_embeds": torch.empty((B, n, cfg.d_model), dtype=dt,
                                          device=META)}
    batch = {"tokens": torch.empty((B, S), dtype=torch.int64, device=META)}
    if cfg.family == "encdec":
        batch["frames"] = torch.empty((B, cfg.max_source_len, cfg.d_model),
                                      dtype=dt, device=META)
    return batch


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh=None):
    """(cache, prev) of one serve step with a cache of ``seq_len``
    positions (a sliding window's ring holds min(seq_len, W)): the
    cache at this rank's blocks on ``mesh`` (``models.api.init_cache``),
    the previous tokens (B,) int64 whole."""
    B, S = shape.global_batch, shape.seq_len
    kw = {"source_len": cfg.max_source_len} if cfg.family == "encdec" \
        else {}
    cache = model_api.init_cache(cfg, B, S, device=META, mesh=mesh, **kw)
    return cache, torch.empty((B,), dtype=torch.int64, device=META)


def abstract_opt_state(params: dict, grad_compress: bool = False) -> dict:
    """AdamW's state of ``params``: fp32 m and v at each leaf's shape
    (``err`` too with ``grad_compress``) and the int32 step."""
    f32 = lambda t: torch.empty(t.shape, dtype=torch.float32,  # noqa: E731
                                device=META)
    tree = lambda p: {k: tree(v) if isinstance(v, dict) else f32(v)  # noqa
                      for k, v in p.items()}
    st = {"m": tree(params), "v": tree(params),
          "step": torch.empty((), dtype=torch.int32, device=META)}
    if grad_compress:
        st["err"] = tree(params)
    return st


def tree_bytes(tree) -> int:
    """The bytes of every tensor of a (nested) dict or tuple."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0
