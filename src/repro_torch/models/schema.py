"""Parameter trees of the port's models.

``schema`` declares every parameter as a ``Leaf`` (shape, logical axes,
init) exactly as the JAX package's ``models/schema.py`` does, with the
same layouts: stacked layer weights (L, D, out) used as ``x @ W``.
``init_params`` makes a random tree from a seed with the same leaf shapes
and scales, directly on the target device (a full-width model is a few
GB; it is never staged on the host). ``from_jax`` turns the JAX package's
parameter tree, as numpy arrays, into the port's tensors, so that the two
packages compute the same function in the tests.

The dense, moe (granite-moe, qwen3-moe), ssm (mamba2) and hybrid
(zamba2) families; the vlm image prefix and the encdec family are not
ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from .transformer import torch_dtype


@dataclass(frozen=True)
class Leaf:
    shape: tuple
    axes: tuple            # logical axis name (or None) per dim
    init: str = "normal"   # normal | zeros | ones | a_log | conv
    scale: float = 1.0


def _attn_leaves(cfg: ModelConfig, L: Optional[int]) -> dict:
    D, hd = cfg.d_model, cfg.head_dim
    Hp, Kp = cfg.padded_heads, cfg.padded_kv_heads
    pre = (L,) if L else ()
    lax = ("layers",) if L else ()
    s_in = 1.0 / np.sqrt(D)
    s_out = 1.0 / np.sqrt(Hp * hd)
    leaves = {
        "wq": Leaf(pre + (D, Hp * hd), lax + ("embed", "heads"), "normal", s_in),
        "wk": Leaf(pre + (D, Kp * hd), lax + ("embed", "kv_heads"), "normal", s_in),
        "wv": Leaf(pre + (D, Kp * hd), lax + ("embed", "kv_heads"), "normal", s_in),
        "wo": Leaf(pre + (Hp * hd, D), lax + ("heads", "embed"), "normal", s_out),
    }
    if cfg.qk_norm:
        leaves["q_norm"] = Leaf(pre + (hd,), lax + (None,), "ones")
        leaves["k_norm"] = Leaf(pre + (hd,), lax + (None,), "ones")
    return leaves


def _mlp_leaves(cfg: ModelConfig, L: Optional[int]) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    pre = (L,) if L else ()
    lax = ("layers",) if L else ()
    s_in, s_out = 1.0 / np.sqrt(D), 1.0 / np.sqrt(F)
    return {
        "wi_gate": Leaf(pre + (D, F), lax + ("embed", "mlp"), "normal", s_in),
        "wi_up": Leaf(pre + (D, F), lax + ("embed", "mlp"), "normal", s_in),
        "wo_mlp": Leaf(pre + (F, D), lax + ("mlp", "embed"), "normal", s_out),
    }


def _moe_leaves(cfg: ModelConfig, L: int) -> dict:
    """The router and the E experts' SwiGLU weights of every layer, stacked
    over layers and experts: ``x @ router`` gives the (T, E) logits,
    ``buf[e] @ we_gate[e]`` expert e's gate."""
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    s_in, s_out = 1.0 / np.sqrt(D), 1.0 / np.sqrt(F)
    return {
        "router": Leaf((L, D, E), ("layers", "embed", None), "normal", s_in),
        "we_gate": Leaf((L, E, D, F), ("layers", "expert", "expert_embed",
                                       None), "normal", s_in),
        "we_up": Leaf((L, E, D, F), ("layers", "expert", "expert_embed",
                                     None), "normal", s_in),
        "we_down": Leaf((L, E, F, D), ("layers", "expert", None,
                                       "expert_embed"), "normal", s_out),
    }


def _ssm_leaves(cfg: ModelConfig, L: int) -> dict:
    D = cfg.d_model
    di, N, Hs, KC = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    s = 1.0 / np.sqrt(D)
    return {
        "ln": Leaf((L, D), ("layers", None), "ones"),
        "in_z": Leaf((L, D, di), ("layers", "embed", "ssm_inner"), "normal", s),
        "in_x": Leaf((L, D, di), ("layers", "embed", "ssm_inner"), "normal", s),
        "in_B": Leaf((L, D, N), ("layers", "embed", None), "normal", s),
        "in_C": Leaf((L, D, N), ("layers", "embed", None), "normal", s),
        "in_dt": Leaf((L, D, Hs), ("layers", "embed", "ssm_inner"), "normal", s),
        "conv_w": Leaf((L, KC, di + 2 * N), ("layers", None, "ssm_inner"), "conv"),
        "A_log": Leaf((L, Hs), ("layers", "ssm_inner"), "a_log"),
        "D_skip": Leaf((L, Hs), ("layers", "ssm_inner"), "ones"),
        "dt_bias": Leaf((L, Hs), ("layers", "ssm_inner"), "zeros"),
        "out_proj": Leaf((L, di, D), ("layers", "ssm_inner", "embed"),
                         "normal", 1.0 / np.sqrt(di)),
    }


def _norm(L: Optional[int], name: str, D: int) -> dict:
    if L:
        return {name: Leaf((L, D), ("layers", None), "ones")}
    return {name: Leaf((D,), (None,), "ones")}


def schema(cfg: ModelConfig) -> dict:
    """Nested dict of Leaf for the given (dense, moe, ssm or hybrid)
    config. A moe layer has the dense layer's attention and norms, and the
    router and experts in place of the MLP. The hybrid's ``shared_attn``
    (one unstacked attention + MLP block) sorts after every other key, so
    ``init_params`` draws it last."""
    if cfg.family not in ("dense", "vlm", "moe", "ssm", "hybrid"):
        raise NotImplementedError(
            f"the port has the dense, moe, ssm and hybrid families only so "
            f"far (got {cfg.family!r})")
    D, L, Vp = cfg.d_model, cfg.n_layers, cfg.padded_vocab
    tree: dict = {"embed": Leaf((Vp, D), ("vocab_rows", "embed"), "normal", 1.0)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = Leaf((D, Vp), ("embed_head", "vocab"), "normal",
                               1.0 / np.sqrt(D))
    tree.update(_norm(None, "final_norm", D))
    if cfg.family == "ssm":
        tree["layers"] = _ssm_leaves(cfg, L)
    elif cfg.family == "hybrid":
        tree["layers"] = _ssm_leaves(cfg, L)
        tree["shared_attn"] = {**_attn_leaves(cfg, None),
                               **_mlp_leaves(cfg, None),
                               **_norm(None, "ln1", D),
                               **_norm(None, "ln2", D)}
    elif cfg.family == "moe":
        tree["layers"] = {**_attn_leaves(cfg, L), **_moe_leaves(cfg, L),
                          **_norm(L, "ln1", D), **_norm(L, "ln2", D)}
    else:
        tree["layers"] = {**_attn_leaves(cfg, L), **_mlp_leaves(cfg, L),
                          **_norm(L, "ln1", D), **_norm(L, "ln2", D)}
    return tree


def _leaves_sorted(tree: dict, prefix=()):
    """(path, Leaf) pairs in sorted-key order (the JAX tree order)."""
    for key in sorted(tree):
        v = tree[key]
        if isinstance(v, dict):
            yield from _leaves_sorted(v, prefix + (key,))
        else:
            yield prefix + (key,), v


def _set(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from ``seed``: each leaf drawn in turn (sorted
    key order) from one ``torch.Generator`` on ``device``, in float32,
    scaled, then cast to the config dtype. The same seed, device and
    torch build give the same weights, which is what lets compress and
    decompress run in separate processes."""
    device = torch.device("cpu" if device is None else device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    dtype = torch_dtype(cfg.dtype)
    params: dict = {}
    for path, leaf in _leaves_sorted(schema(cfg)):
        if leaf.init == "ones":
            arr = torch.ones(leaf.shape, dtype=dtype, device=device)
        elif leaf.init == "zeros":
            arr = torch.zeros(leaf.shape, dtype=dtype, device=device)
        elif leaf.init == "a_log":      # mamba2: A uniform in [1, 16), log
            u = torch.rand(leaf.shape, generator=gen, device=device,
                           dtype=torch.float32)
            arr = torch.log(u.mul_(15.0).add_(1.0)).to(dtype)
        elif leaf.init == "conv":       # normal over sqrt(fan-in)
            fan = leaf.shape[-2] if len(leaf.shape) > 1 else 4
            arr = torch.randn(leaf.shape, generator=gen, device=device,
                              dtype=torch.float32)
            arr = arr.div_(float(np.sqrt(fan))).to(dtype)
        else:
            arr = torch.randn(leaf.shape, generator=gen, device=device,
                              dtype=torch.float32)
            arr = arr.mul_(leaf.scale).to(dtype)
        _set(params, path, arr)
    return params


def _leaf_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes bf16: exact via f32
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # own copy


def from_jax(params_np: dict, device=None) -> dict:
    """The JAX package's parameter tree (nested dict of numpy arrays:
    ``embed``, ``lm_head``, ``final_norm``, and ``layers/{wq, wk, wv, wo,
    q_norm, k_norm, wi_gate, wi_up, wo_mlp, ln1, ln2}`` for the dense
    family (the moe family has ``router, we_gate, we_up, we_down`` in
    place of the MLP's three) or ``layers/{ln, in_z, in_x, in_B, in_C,
    in_dt, conv_w, A_log, D_skip, dt_bias, out_proj}`` for the ssm
    family; the hybrid family has the ssm ``layers`` and
    ``shared_attn/{wq, wk, wv, wo, wi_gate, wi_up, wo_mlp, ln1, ln2}``,
    unstacked) as the port's tensors: same names, same layouts, same
    dtypes."""
    device = torch.device("cpu" if device is None else device)
    return {k: from_jax(v, device) if isinstance(v, dict)
            else _leaf_tensor(v, device) for k, v in params_np.items()}


def count_params(cfg: ModelConfig) -> int:
    return int(sum(np.prod(leaf.shape)
                   for _, leaf in _leaves_sorted(schema(cfg))))
