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

mamba2's conv leaves (``conv_w`` (L, KC, di + 2N) and the cache's
``conv`` (L, B, KC - 1, di + 2N)) keep JAX's spec, the logical
``ssm_inner`` over the concatenated channels [xc | B | C], but not its
even cut: an even cut of di + 2N does not line up with the split into
xc, B and C (mamba2-130m at TP 2: 896 channels a rank against an xc
block of 768), which GSPMD reshards around and a hand-sharded rank
cannot. A rank holds its block of xc's channels, followed by B and C
whole (``cut_conv``; di / tp + 2N channels), the layout its own
projections give it; ``gather_conv`` and ``join_conv`` put the global
leaf back together. Their specs are ``ConvSpec``s (tuples equal to
JAX's that also carry 2N), so ``cut`` and ``local_shape``, and the code
that reads a spec tree alone (the optimizer's norm, a checkpoint's
gather), take the layout from the spec.

One difference from the JAX trees: JAX keeps the decode positions
``pos`` whole on every device (P()), since its step is one global
program; a rank here runs only its own lanes, so ``shard_cache`` cuts
``pos`` along the lanes as the K/V leaves' batch dimension is cut.
"""
from __future__ import annotations

import torch

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
    """Spec tree matching ``init_params``' structure; mamba2's ``conv_w``
    has a ``ConvSpec`` (equal to JAX's tuple), which tells the code that
    cuts, gathers or reduces a leaf by its spec alone (a checkpoint, the
    optimizer's norm) the port's conv layout."""
    r = _rules(cfg, mesh, layout)
    out = _map(param_axes(cfg), lambda axes: tuple(r[a] for a in axes))
    if cfg.family in ("ssm", "hybrid"):
        out["layers"]["conv_w"] = ConvSpec(out["layers"]["conv_w"],
                                           2 * cfg.ssm_state)
    return out


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


def seq_axes(cfg: ModelConfig, mesh, *, lanes_cut: bool) -> tuple:
    """The mesh axes an attention cache's sequence (a ring's slots, the
    encdec source) is cut over, outermost first, as ``cache_pspecs``
    lays it out: ('pod',) 'data' when the lanes are not cut over the
    batch axes (``lanes_cut``: the batch divides them) and 'data' has
    more than one rank, then 'model' when the padded KV heads do not
    divide it. () where the sequence is whole on every rank."""
    axes = []
    if not lanes_cut and mesh_degree(mesh, "data") > 1:
        axes += [a for a in ("pod", "data") if a in mesh.axis_names]
    if cfg.padded_kv_heads % mesh_degree(mesh, "model"):
        axes.append("model")
    return tuple(axes)


def seq_block(cfg: ModelConfig, mesh, length: int, *,
              lanes_cut: bool) -> tuple[int, int]:
    """(lo, n): this rank's slots [lo, lo + n) of a cache sequence of
    ``length`` (a ring's min(max_len, W) slots, a linear cache's
    max_len, the encdec source) cut over ``seq_axes``, in the row-major
    order of that tuple (``block``); (0, length) where it is whole."""
    return block(mesh, seq_axes(cfg, mesh, lanes_cut=lanes_cut), length)


def cache_pspecs(cfg: ModelConfig, mesh, *, batch: int) -> dict:
    """Spec tree matching ``init_cache``'s structure at decode shapes:
    the cache batch over (pod, data) when it divides; KV heads over
    'model' when they divide, else the sequence over 'model'; a batch
    that does not divide puts the sequence over 'data' (and 'pod')."""
    tp = mesh_degree(mesh, "model")
    b_ax = _batch_spec(mesh, batch)
    kv_ok = cfg.padded_kv_heads % tp == 0
    seq_ax = _entry(seq_axes(cfg, mesh, lanes_cut=b_ax is not None))
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
        specs["conv"] = ConvSpec((None, b_ax, None, inner_ax),
                                 2 * cfg.ssm_state)
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
    (dims past the spec's are whole; a ``ConvSpec``'s last dim as
    ``cut`` cuts it)."""
    tail = whole_tail(mesh, spec)
    if tail:
        out = local_shape(mesh, tuple(spec[:-1]) + (None,), shape)
        return out[:-1] + (block(mesh, spec[-1], shape[-1] - tail)[1]
                           + tail,)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(block(mesh, e, n)[1] for e, n in zip(spec, shape))


def cut(t, mesh, spec: tuple):
    """This rank's block of ``t`` under ``spec``, as a tensor of its own
    (the whole can be freed); ``t`` itself where no dim is cut. A
    ``ConvSpec`` cuts the last dim in the port's conv layout
    (``cut_conv``)."""
    if isinstance(spec, ConvSpec) and whole_tail(mesh, spec):
        rest = cut(t, mesh, tuple(spec[:-1]) + (None,))
        return _cut_channels(rest, mesh, spec[-1], t.shape[-1] - spec.bc)
    out = t
    for dim, entry in enumerate(spec):
        start, n = block(mesh, entry, t.shape[dim])
        if n != t.shape[dim]:
            out = out.narrow(dim, start, n)
    return out.clone() if out is not t else out


# ------------------------------------------------------- mamba2's conv
#: the leaves whose last dim is mamba2's conv channels [xc | B | C]: the
#: parameter ``conv_w`` and the cache's ``conv``
CONV_LEAVES = ("conv_w", "conv")


class ConvSpec(tuple):
    """The spec of a conv leaf (``CONV_LEAVES``: JAX's, and equal to its
    tuple) in the port's layout: its last dim's trailing ``bc`` channels
    (B and C, 2N) are whole on every rank of the axes its last entry
    names, the channels before them cut by it (``cut_conv``). ``cut``
    and ``local_shape`` cut such a leaf so, and the optimizer's norm and
    a checkpoint's gather read ``bc`` (``whole_tail``)."""

    def __new__(cls, spec, bc: int):
        self = super().__new__(cls, spec)
        self.bc = int(bc)
        return self

    def __getnewargs__(self):
        return tuple(self), self.bc


def whole_tail(mesh, spec) -> int:
    """The trailing channels of a leaf's last dim that are whole on every
    rank although ``spec`` cuts that dim on ``mesh``: a ``ConvSpec``'s
    ``bc`` where its last entry cuts (over more than one rank), else
    0."""
    if not isinstance(spec, ConvSpec) or not spec:
        return 0
    axes = _axes_of(spec[-1])
    return spec.bc if axes and mesh.degree(axes) > 1 else 0


def cut_conv(t, cfg: ModelConfig, mesh, entry):
    """This rank's block of a conv leaf ``t`` (last dim di + 2N) whose
    last dim JAX's spec cuts by ``entry``: its block of xc's di
    channels, then B and C whole (di / n + 2N channels); ``t`` itself
    where ``entry`` cuts nothing."""
    if not _axes_of(entry):
        return t
    return _cut_channels(t, mesh, entry, cfg.ssm_d_inner)


def _cut_channels(t, mesh, entry, di: int):
    """``t``'s block of its first ``di`` channels under ``entry``, then
    the channels after them whole (a new tensor)."""
    start, n = block(mesh, entry, di)
    return torch.cat([t[..., start:start + n], t[..., di:]], dim=-1)


def join_conv(blocks: list, cfg: ModelConfig):
    """The global conv leaf from the blocks (``cut_conv``) of the ranks
    along its cut, in their order: the xc blocks side by side, then B
    and C (whole on every rank)."""
    bc = 2 * cfg.ssm_state
    return torch.cat([b[..., :b.shape[-1] - bc] for b in blocks]
                     + [blocks[0][..., blocks[0].shape[-1] - bc:]], dim=-1)


def gather_conv(local, cfg: ModelConfig, mesh, entry):
    """The global conv leaf on every rank from this rank's block
    (``cut_conv``): the xc blocks gathered over ``entry``'s axes."""
    axes = _axes_of(entry)
    if not axes:
        return local
    return join_conv(list(mesh.all_gather(local[None], axes, dim=0)), cfg)


def shard_params(params: dict, cfg: ModelConfig, mesh,
                 layout: str = "serve") -> dict:
    """This rank's block of every leaf of the whole tree ``params`` (from
    ``init_params`` or ``from_jax``), leaf by leaf (``conv_w`` in the
    port's layout: its ``ConvSpec``)."""
    specs = param_pspecs(cfg, mesh, layout)

    def walk(p, s):
        return {k: walk(v, s[k]) if isinstance(v, dict)
                else cut(v, mesh, s[k])
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


def _cache_spec(specs: dict, name: str, shape: tuple, batch: int) -> tuple:
    """The spec of cache leaf ``name`` of ``shape``: ``pos`` is cut
    along the lanes as the K/V (or conv) are; the encdec cross K/V of
    ONE source (a lane dim of 1 that every lane reads) are not cut along
    the lanes."""
    if name == "pos":
        return (_lane_spec(specs),)
    spec = specs[name]
    if name in ("xk", "xv") and shape[1] == 1 and batch != 1:
        spec = (spec[0], None) + tuple(spec[2:])
    return spec


def shard_cache(cache: dict, cfg: ModelConfig, mesh, *, batch: int) -> dict:
    """This rank's block of every leaf of a whole decode cache of
    ``batch`` lanes (``conv`` in the port's layout: its ``ConvSpec``)."""
    specs = cache_pspecs(cfg, mesh, batch=batch)
    return {k: cut(v, mesh, _cache_spec(specs, k, tuple(v.shape), batch))
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
    return {k: local_shape(mesh, _cache_spec(specs, k, tuple(s), batch),
                           tuple(s))
            for k, s in shapes.items()}
