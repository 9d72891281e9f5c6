"""Logical axis -> mesh axis mapping (the sharding policy), as the JAX
package's ``sharding/specs.py`` decides it, and the cuts it implies.

A spec is a plain tuple with one entry per dimension: None (whole on
every rank), a mesh axis name, or a tuple of two or more axis names (the
dimension cut over their product, outermost first), as a JAX
``PartitionSpec`` lists them (it writes a tuple of one name as the
name). ``param_pspecs``, ``cache_pspecs``, ``batch_pspecs`` and
``logits_pspec`` give, entry for entry, the JAX package's specs for the
same config and mesh: every parameter, activation and cache tensor laid
out on the (pod, data, model) mesh, with its divisibility fallbacks
(KV heads that do not divide the model axis -> a cache cut along the
sequence; a batch that does not divide the batch axes -> whole on every
rank; small SSM head counts -> a replicated inner dim).

``shard_params`` and ``shard_cache`` cut the port's whole trees down to
this rank's block of every leaf, leaf by leaf; ``init_params_sharded``
draws each leaf of ``init_params`` from the seed in turn and keeps only
this rank's block, so the peak is one whole leaf, never the whole model.
A cache is allocated directly at this rank's shapes (``local_shape``).

One difference from the JAX trees: JAX keeps the decode positions
``pos`` whole on every device (P()), since its step is one global
program; a rank here runs only its own lanes, so ``shard_cache`` cuts
``pos`` along the lanes as the K/V leaves' batch dimension is cut.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import batch_axes, mesh_degree

LAYOUTS = ("train", "serve")


def _rules(cfg: ModelConfig, mesh, layout: str = "train") -> dict:
    """layout="train": FSDP (D rows over 'data') + TP. layout="serve":
    weights resident, 1D TP only; the moe expert weights keep D over
    'data' (the serve moe path sums D-partials over 'data' instead of
    gathering)."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} (one of {LAYOUTS})")
    tp = mesh_degree(mesh, "model")
    dp = mesh_degree(mesh, "data")
    ssm_ok = cfg.family in ("ssm", "hybrid") and \
        cfg.ssm_heads % tp == 0 and cfg.ssm_d_inner % tp == 0
    embed_rule = "data" if cfg.d_model % dp == 0 and dp > 1 else None
    if layout == "serve":
        embed_rule = None
    return {
        "embed": embed_rule,
        "expert_embed": "data" if cfg.d_model % dp == 0 and dp > 1 else None,
        "vocab_rows": None,
        "embed_head": None,
        "heads": "model" if (cfg.padded_heads * cfg.head_dim) % tp == 0
        else None,
        "kv_heads": "model" if cfg.padded_kv_heads % tp == 0 else None,
        "mlp": "model" if cfg.d_ff % tp == 0 and cfg.d_ff else None,
        "vocab": "model" if cfg.padded_vocab % tp == 0 else None,
        "expert": "model" if cfg.n_experts % tp == 0 and cfg.n_experts
        else None,
        "ssm_inner": "model" if ssm_ok else None,
        "layers": None,
        None: None,
    }


rules = _rules


def _map(tree: dict, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def param_axes(cfg: ModelConfig) -> dict:
    """The logical axes of every parameter leaf (``models/schema.py``)."""
    from repro_torch.models.schema import schema
    return _map(schema(cfg), lambda leaf: leaf.axes)


def param_pspecs(cfg: ModelConfig, mesh, layout: str = "train") -> dict:
    """Spec tree matching ``init_params``' structure."""
    r = _rules(cfg, mesh, layout)
    return _map(param_axes(cfg), lambda axes: tuple(r[a] for a in axes))


def _entry(axes: tuple):
    """A spec entry for a dimension cut over ``axes``."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def _batch_spec(mesh, batch: int):
    ba = batch_axes(mesh)
    nb = 1
    for a in ba:
        nb *= mesh.shape[a]
    return _entry(ba) if ba and batch % nb == 0 else None


def batch_pspecs(cfg: ModelConfig, mesh, *, global_batch: int) -> dict:
    """Input batch specs: the batch dim over (pod, data) when it
    divides."""
    bspec = _batch_spec(mesh, global_batch)
    specs = {"tokens": (bspec, None)}
    if cfg.family == "vlm":
        specs["img_embeds"] = (bspec, None, None)
    if cfg.family == "encdec":
        specs["frames"] = (bspec, None, None)
    return specs


def cache_pspecs(cfg: ModelConfig, mesh, *, batch: int) -> dict:
    """Spec tree matching ``init_cache``'s structure at decode shapes:
    the cache batch over (pod, data) when it divides; KV heads over
    'model' when they divide, else the sequence over 'model'; a batch
    that does not divide puts the sequence over 'data' (and 'pod')."""
    tp = mesh_degree(mesh, "model")
    b_ax = _batch_spec(mesh, batch)
    kv_ok = cfg.padded_kv_heads % tp == 0
    seq_ax = []
    if b_ax is None and mesh_degree(mesh, "data") > 1:
        seq_ax.append("data")
        if "pod" in mesh.axis_names:
            seq_ax.insert(0, "pod")
    if not kv_ok:
        seq_ax.append("model")
    seq_ax = _entry(tuple(seq_ax))
    kv_spec = (None, b_ax, seq_ax, "model" if kv_ok else None, None)

    specs = {"pos": ()}
    if cfg.family in ("dense", "vlm", "moe", "encdec"):
        specs["k"] = kv_spec
        specs["v"] = kv_spec
        if cfg.kv_cache_dtype == "int8" and cfg.family != "encdec":
            specs["k_scale"] = kv_spec[:4]
            specs["v_scale"] = kv_spec[:4]
    if cfg.family == "encdec":
        specs["xk"] = kv_spec
        specs["xv"] = kv_spec
    if cfg.family in ("ssm", "hybrid"):
        ssm_ok = cfg.ssm_heads % tp == 0 and cfg.ssm_d_inner % tp == 0
        inner_ax = "model" if ssm_ok else None
        specs["conv"] = (None, b_ax, None, inner_ax)
        specs["state"] = (None, b_ax, inner_ax, None, None)
    if cfg.family == "hybrid":
        specs["k"] = kv_spec
        specs["v"] = kv_spec
    return specs


def logits_pspec(cfg: ModelConfig, mesh, *, global_batch: int) -> tuple:
    tp = mesh_degree(mesh, "model")
    return (_batch_spec(mesh, global_batch), None,
            "model" if cfg.padded_vocab % tp == 0 else None)


# -------------------------------------------------------------- cutting
def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def block(mesh, entry, size: int) -> tuple[int, int]:
    """(start, length) of this rank's block of a dimension of ``size``
    cut by ``entry`` (None, an axis, or a tuple of axes); raises when the
    axes' product does not divide ``size``."""
    axes = _axes_of(entry)
    n = mesh.degree(axes) if axes else 1
    if size % n:
        raise ValueError(f"a dimension of {size} does not divide over "
                         f"{axes} ({n} ranks)")
    step = size // n
    return (mesh.axis_index(axes) * step if axes else 0), step


def local_shape(mesh, spec: tuple, shape: tuple) -> tuple:
    """This rank's block shape of a tensor of ``shape`` under ``spec``
    (dims past the spec's are whole)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(block(mesh, e, n)[1] for e, n in zip(spec, shape))


def cut(t, mesh, spec: tuple):
    """This rank's block of ``t`` under ``spec``, as a tensor of its own
    (the whole can be freed); ``t`` itself where no dim is cut."""
    out = t
    for dim, entry in enumerate(spec):
        start, n = block(mesh, entry, t.shape[dim])
        if n != t.shape[dim]:
            out = out.narrow(dim, start, n)
    return out.clone() if out is not t else out


def shard_params(params: dict, cfg: ModelConfig, mesh,
                 layout: str = "serve") -> dict:
    """This rank's block of every leaf of the whole tree ``params`` (from
    ``init_params`` or ``from_jax``), leaf by leaf."""
    specs = param_pspecs(cfg, mesh, layout)

    def walk(p, s):
        return {k: walk(v, s[k]) if isinstance(v, dict) else cut(v, mesh,
                                                                s[k])
                for k, v in p.items()}
    return walk(params, specs)


def init_params_sharded(cfg: ModelConfig, mesh, seed: int = 0,
                        device=None, layout: str = "serve") -> dict:
    """``shard_params(init_params(cfg, seed, device))`` without the whole
    tree: each leaf is drawn whole from the seed's generator in turn (so
    every rank draws the same values) and cut at once."""
    from repro_torch.models.schema import init_params
    specs = param_pspecs(cfg, mesh, layout)

    def keep(path, arr):
        s = specs
        for k in path:
            s = s[k]
        return cut(arr, mesh, s)
    return init_params(cfg, seed, device, keep=keep)


def shard_cache(cache: dict, cfg: ModelConfig, mesh, *, batch: int) -> dict:
    """This rank's block of every leaf of a whole decode cache of
    ``batch`` lanes; ``pos`` is cut along the lanes as the K/V are."""
    specs = cache_pspecs(cfg, mesh, batch=batch)
    lanes = _lane_spec(specs)
    return {k: cut(v, mesh, (lanes,) if k == "pos" else specs[k])
            for k, v in cache.items()}


def _lane_spec(specs: dict):
    for name in ("k", "conv"):
        if name in specs:
            return specs[name][1]
    return None


def cache_local_shapes(cfg: ModelConfig, mesh, shapes: dict, *,
                       batch: int) -> dict:
    """This rank's shapes of a cache whose whole leaves have ``shapes``
    (name -> shape)."""
    specs = cache_pspecs(cfg, mesh, batch=batch)
    lanes = _lane_spec(specs)
    return {k: local_shape(mesh, (lanes,) if k == "pos" else specs[k], s)
            for k, s in shapes.items()}
