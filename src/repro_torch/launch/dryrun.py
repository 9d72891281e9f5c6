"""Production dry run: trace rank 0's step of every (architecture x input
shape) cell on the production meshes, and record its memory, cost and
collectives: the port's counterpart of the JAX package's
``launch/dryrun.py``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_14b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single   # 16x16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multi    # 2x16x16

JAX lowers and compiles each cell's jitted global program on 512 fake
host devices. The port's steps are one rank's eager programs, so the
dry run runs rank 0's step itself, on the ``meta`` device: every tensor
has a shape and a dtype and no storage, the kernel wrappers return
their outputs' shapes (``kernels/ops.py``), and the collectives are a
stand-in mesh's (``launch.mesh.StandInMesh``), which moves no data and
logs each collective. One process traces rank 0 of a 256- or 512-rank
mesh; no card is needed, by design, as JAX's dry run needs no TPU.

Per cell: ``train`` runs ``train/train_loop.py``'s step with JAX's
``MICROBATCHES`` (the parameters and AdamW's state at rank 0's blocks in
the train layout), ``prefill`` ``serve/steps.py``'s ``make_score_step``
(the moe family in the train layout, as JAX scores it), ``decode``
``make_serve_step`` over a cache of the shape's length at rank 0's
blocks (a batch of 1 cuts it along the sequence over 'data'). It
records:

  * ``memory``: the argument bytes (parameters, optimizer state or
    cache, the batch as the step takes it) and the peak of live tensor
    bytes during the step (every tensor a traced op creates, from its
    creation until it is freed), per device;
  * ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count of
    aten's products, plus each hand-written kernel's formula
    (``ops.META_FLOPS``), as JAX's ``_attn_flops_dense`` counts
    attention analytically; ``bytes_accessed``, each traced op's
    inputs and outputs (the counterpart of XLA's "bytes accessed");
  * ``collectives``: the stand-in's log, summed under JAX's keys
    (``hlo_analysis.collective_stats``);
  * ``roofline``: those against one H100 SXM's published peaks
    (``hlo_analysis.Roofline``): projected, not measured.

Each cell writes ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``
(existing entries are kept unless ``--force``). The skips are JAX's
(``cell_applicable``); a cell that raises writes an ``.err`` sidecar, is
counted, and makes the exit code 1, as JAX's ``run_cells``. Where a
full-depth trace is too slow (the train cells: up to 94 layers times 16
microbatches), probes trace 1- to 3-layer configs at 2 and 3
microbatches and extrapolate each quantity to the full depth and
microbatch count, as JAX's ``probe_roofline`` (``--probe``; held equal
to a full trace at a tiny size in ``tests/test_torch_dryrun.py``).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import obs
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.kernels import ops
from repro_torch.launch import hlo_analysis
from repro_torch.launch.input_specs import (abstract_opt_state,
                                            abstract_params,
                                            decode_input_specs,
                                            train_input_specs, tree_bytes)
from repro_torch.launch.mesh import make_production_mesh

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" \
    / "dryrun_torch"

#: long_500k runs only for the sub-quadratic archs (SSM / hybrid / SWA)
SUBQUADRATIC = {"mamba2_130m", "zamba2_7b", "h2o_danube_3_4b"}

#: grad-accum microbatches of train_4k, per arch (JAX's)
MICROBATCHES = {
    "qwen3_moe_235b_a22b": 16, "llava_next_34b": 16, "qwen3_14b": 16,
    "deepseek_7b": 16, "zamba2_7b": 8, "h2o_danube_3_4b": 8,
    "qwen3_1_7b": 16, "granite_moe_1b_a400m": 8, "whisper_large_v3": 8,
    "mamba2_130m": 4,
}


def cell_applicable(arch_id: str, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and arch_id not in SUBQUADRATIC:
        return False, "long_500k needs sub-quadratic attention (DESIGN.md §5)"
    return True, ""


def _is_view(func) -> bool:
    """Whether an aten op returns a view of an input (an alias it does
    not write): it reads and writes no data."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class LiveBytes(TorchDispatchMode):
    """The bytes of the tensors a traced program holds: ``base`` (its
    arguments, held by the caller throughout) plus every storage an op
    creates, from its creation until it is freed. An output that shares
    an input's storage (a view, an in-place op) adds nothing. ``peak``
    is the most held at once; ``accessed`` sums every op's input and
    output bytes, views' aside."""

    def __init__(self, base: int = 0):
        super().__init__()
        self.base = int(base)
        self.held = 0
        self.peak = self.base
        self.accessed = 0
        self._live = {}            # storage id -> (weak ref, bytes)
        self._ops = 0

    def _sweep(self) -> None:
        for key, (ref, n) in list(self._live.items()):
            if ref.expired():
                del self._live[key]
                self.held -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        seen = {StorageWeakRef(t.untyped_storage()).cdata for t in ins}
        new = 0
        for t in outs:
            ref = StorageWeakRef(t.untyped_storage())
            if ref.cdata in seen or ref.cdata in self._live:
                continue
            n = t.untyped_storage().nbytes()
            self._live[ref.cdata] = (ref, n)
            new += n
        if not _is_view(func):          # a view moves no data
            self.accessed += sum(t.numel() * t.element_size()
                                 for t in ins + outs)
        self.held += new
        self._ops += 1
        if self._ops % 4096 == 0:
            self._sweep()
        if self.base + self.held > self.peak:
            self._sweep()           # only what is still held counts
            self.peak = max(self.peak, self.base + self.held)
        return out


def _with_layers(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    kw = dict(n_layers=n_layers)
    if cfg.family == "encdec":
        kw["n_enc_layers"] = n_layers
    return cfg.with_(**kw)


def trace_step(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               num_microbatches: int = 1, loss_block: int = 0) -> dict:
    """Run rank ``mesh.rank``'s step of one cell on the meta device and
    return what it cost: argument bytes (params, state, batch), the
    peak of live bytes, FLOPs (aten's and the kernels'), bytes
    accessed, the collective log, and the trace's seconds."""
    from repro_torch.serve import steps
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import make_train_step
    mesh.log.clear()
    mesh.calls = mesh.bytes = 0
    if shape.kind == "train":
        params = abstract_params(cfg, mesh, "train")
        state = abstract_opt_state(params)
        batch = train_input_specs(cfg, shape)
        step = make_train_step(cfg, mesh, opt=AdamWConfig(),
                               num_microbatches=num_microbatches,
                               global_batch=shape.global_batch,
                               loss_block=loss_block)
        run = lambda: step(params, state, batch)  # noqa: E731
    elif shape.kind == "prefill":
        layout = steps.score_layout(cfg, mesh)
        params = abstract_params(cfg, mesh, layout)
        state = {}
        batch = train_input_specs(cfg, shape)
        step = steps.make_score_step(cfg, mesh, topk=64,
                                     global_batch=shape.global_batch)
        run = lambda: step(params, batch)  # noqa: E731
    else:
        params = abstract_params(cfg, mesh, "serve")
        state, prev = decode_input_specs(cfg, shape, mesh)
        batch = {"prev": prev}
        step = steps.make_serve_step(cfg, mesh, batch=shape.global_batch,
                                     topk=64)
        run = lambda: step(params, state, prev)  # noqa: E731
    args = {"params": tree_bytes(params), "state": tree_bytes(state),
            "batch": tree_bytes(batch)}
    t0 = time.perf_counter()
    live = LiveBytes(sum(args.values()))
    with ops.meta_trace() as kernels, \
            FlopCounterMode(display=False) as counter, live:
        run()
    by_kernel: dict = {}
    for name, f in kernels:
        by_kernel[name] = by_kernel.get(name, 0) + f
    aten = int(counter.get_total_flops())
    return {"argument_bytes": args, "peak_bytes": live.peak,
            "temp_bytes": live.peak - live.base,
            "flops": aten + sum(by_kernel.values()), "aten_flops": aten,
            "kernel_flops": by_kernel, "kernel_calls": len(kernels),
            "bytes_accessed": live.accessed, "log": list(mesh.log),
            "trace_s": time.perf_counter() - t0}


def _probe_points(cfg: ModelConfig) -> list:
    """(probe config, its depth features): a step's traced quantities
    are linear in these. The layers L and L^2: the backward of each
    layer's slice ``w[layer]`` of a stacked weight is a zeroed (L, ...)
    gradient with the slice copied in, summed over the L layers, so the
    bytes a train step touches grow with L^2 (its FLOPs do not).
    Dense, moe, vlm, ssm: L = 1, 2, 3; encdec: its decoder and encoder
    layers together (the config's must be equal); hybrid: its SSD
    layers s (and s^2) and the shared block's applications a (an
    unstacked weight), from (s, a) = (1, 1), (2, 2), (2, 1), (3, 3)."""
    if cfg.family == "hybrid":
        pts = [(1, 1), (2, 1), (2, 2), (3, 1)]
        return [(cfg.with_(n_layers=n, hybrid_ssm_per_block=per),
                 _depth_features(n, n // per)) for n, per in pts]
    if cfg.family == "encdec" and cfg.n_enc_layers != cfg.n_layers:
        raise ValueError(f"probes of {cfg.name} need equal encoder and "
                         f"decoder depths ({cfg.n_enc_layers}, "
                         f"{cfg.n_layers}); trace it whole (--probe off)")
    return [(_with_layers(cfg, n), _depth_features(n)) for n in (1, 2, 3)]


def _depth_features(layers: int, applications=None) -> tuple:
    f = (1.0, float(layers), float(layers) ** 2)
    return f if applications is None else f + (float(applications),)


def _depth(cfg: ModelConfig) -> tuple:
    """The full config's depth features (``_probe_points``')."""
    if cfg.family == "hybrid":
        return _depth_features(cfg.n_layers,
                               cfg.n_layers // cfg.hybrid_ssm_per_block)
    return _depth_features(cfg.n_layers)


def _linear_fields(m: dict) -> dict:
    """A trace's quantities that grow linearly with the depth and the
    microbatches, by name."""
    out = {"flops": m["flops"], "aten_flops": m["aten_flops"],
           "bytes_accessed": m["bytes_accessed"],
           "temp_bytes": m["temp_bytes"]}
    for k, v in m["kernel_flops"].items():
        out[f"kernel/{k}"] = v
    c = hlo_analysis.collective_stats(m["log"])
    for kind, v in c["by_kind"].items():
        out[f"coll/{kind}/bytes"] = v["bytes"]
        out[f"coll/{kind}/count"] = v["count"]
    return out


def probe_step(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               num_microbatches: int = 1, loss_block: int = 0) -> dict:
    """``trace_step``'s quantities from probes (JAX's
    ``probe_roofline``): shallow configs (``_probe_points``) traced at
    two microbatch counts (2 and 3 of the cell's microbatch rows; one
    microbatch where the cell has one), each quantity (FLOPs, bytes
    accessed, the collectives' bytes and counts) fitted as linear in
    the depth features times an affine function of the microbatches
    (the optimizer runs once a step, each microbatch's forward and
    backward once each), and evaluated at the config's depth and
    microbatches: exact for what is so. The peak's temporary bytes are
    fitted without the square term, by least squares (an estimate),
    over the full depth's argument bytes."""
    import numpy as np
    rows = shape.global_batch // num_microbatches
    ms = (1,) if num_microbatches == 1 else (2, 3)
    feats, fields, t = [], [], 0.0
    for pc, depth in _probe_points(cfg):
        for m in ms:
            ps = ShapeConfig(shape.name, shape.seq_len, rows * m,
                             shape.kind)
            r = trace_step(pc, ps, mesh, num_microbatches=m,
                           loss_block=loss_block)
            t += r["trace_s"]
            feats.append(np.outer((1.0, float(m)), depth).ravel()
                         if len(ms) > 1 else np.asarray(depth))
            fields.append(_linear_fields(r))
    A = np.stack(feats)
    x = _depth(cfg)
    at = np.outer((1.0, float(num_microbatches)), x).ravel() \
        if len(ms) > 1 else np.asarray(x)
    names = sorted({k for f in fields for k in f})
    # the peak's temporaries: a least-squares fit without the square
    # term (what a step holds at once grows with its depth, not with its
    # square: the (L, ...) gradients of a stacked weight are summed one
    # at a time)
    lin = np.asarray([j % len(x) != 2 for j in range(A.shape[1])])
    est = {}
    for k in names:
        y = np.asarray([f.get(k, 0) for f in fields], dtype=np.float64)
        if k == "temp_bytes":
            coef = np.linalg.lstsq(A[:, lin], y, rcond=None)[0]
            est[k] = max(0.0, float(at[lin] @ coef))
            continue
        coef = np.linalg.solve(A, y) if A.shape[0] == A.shape[1] \
            else np.linalg.lstsq(A, y, rcond=None)[0]
        est[k] = max(0.0, float(at @ coef))
    args = _full_arguments(cfg, shape, mesh)
    kinds = hlo_analysis.collective_stats([])["by_kind"]
    coll = {"by_kind": {kind: {"bytes": est[f"coll/{kind}/bytes"],
                               "count": est[f"coll/{kind}/count"]}
                        for kind in kinds},
            "bf16_promotion_correction_bytes": 0}
    coll["total_bytes"] = sum(v["bytes"] for v in coll["by_kind"].values())
    return {"argument_bytes": args,
            "flops": est["flops"], "aten_flops": est["aten_flops"],
            "kernel_flops": {k[len("kernel/"):]: v for k, v in est.items()
                             if k.startswith("kernel/")},
            "bytes_accessed": est["bytes_accessed"],
            "temp_bytes": est["temp_bytes"],
            "peak_bytes": sum(args.values()) + est["temp_bytes"],
            "collectives": coll, "trace_s": t,
            "probe": {"depths": [d for _, d in _probe_points(cfg)],
                      "microbatches": list(ms)}}


def _full_arguments(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """The argument bytes of the cell's full step, from the input specs
    alone (no trace)."""
    from repro_torch.serve import steps
    if shape.kind == "train":
        params = abstract_params(cfg, mesh, "train")
        return {"params": tree_bytes(params),
                "state": tree_bytes(abstract_opt_state(params)),
                "batch": tree_bytes(train_input_specs(cfg, shape))}
    if shape.kind == "prefill":
        return {"params": tree_bytes(abstract_params(
                    cfg, mesh, steps.score_layout(cfg, mesh))),
                "state": 0,
                "batch": tree_bytes(train_input_specs(cfg, shape))}
    cache, prev = decode_input_specs(cfg, shape, mesh)
    return {"params": tree_bytes(abstract_params(cfg, mesh, "serve")),
            "state": tree_bytes(cache), "batch": tree_bytes(prev)}


def lower_cell(arch_id: str, shape_name: str, mesh, *, extra=None,
               loss_block: int = 0, probe: bool = False) -> dict:
    """Trace one cell (``probe``: from probes) and return its record,
    under JAX's keys where they have a counterpart."""
    cfg = get_config(arch_id)
    if extra:
        cfg = cfg.with_(**{k: v for k, v in extra.items()
                           if hasattr(cfg, k)})
    shape = SHAPES[shape_name]
    n_chips = mesh.size
    nmb = MICROBATCHES.get(arch_id, 4) if shape.kind == "train" else 1
    kw = dict(num_microbatches=nmb, loss_block=loss_block)
    if probe:
        m = probe_step(cfg, shape, mesh, **kw)
        coll = m["collectives"]
    else:
        m = trace_step(cfg, shape, mesh, **kw)
        coll = hlo_analysis.collective_stats(m["log"])
    if shape.kind == "train":
        n_tokens = shape.global_batch * shape.seq_len
        per_token = 6 * cfg.n_active_params()
    elif shape.kind == "prefill":
        n_tokens = shape.global_batch * shape.seq_len
        per_token = 2 * cfg.n_active_params()
    else:
        n_tokens = shape.global_batch
        per_token = 2 * cfg.n_active_params()
    mem_analytic = hlo_analysis.analytic_memory_bytes(
        cfg, shape, n_chips=n_chips, tp=mesh.shape["model"],
        num_microbatches=nmb)
    roof = hlo_analysis.Roofline(
        hlo_flops=float(m["flops"]) * n_chips,
        hlo_bytes=float(m["bytes_accessed"]) * n_chips,
        collective_bytes=float(coll["total_bytes"]), n_chips=n_chips,
        model_flops=float(per_token) * n_tokens,
        memory_bytes_analytic=mem_analytic,
        peak_flops=hlo_analysis.H100_PEAK_FLOPS_BF16
        if cfg.dtype == "bfloat16" else hlo_analysis.H100_PEAK_FLOPS_FP32)
    args = m["argument_bytes"]
    res = {
        "arch": arch_id, "shape": shape_name,
        "mesh": "x".join(str(s) for s in mesh.devices_shape),
        "mesh_axes": list(mesh.axis_names),
        "kind": shape.kind, "n_chips": n_chips, "rank": mesh.rank,
        "loss_block": loss_block, "microbatches": nmb,
        "lower_s": round(m["trace_s"], 1), "compile_s": 0.0,
        "memory": {
            "bytes_per_device": m["peak_bytes"],
            "temp_bytes": m["temp_bytes"],
            "argument_bytes": sum(args.values()),
            "argument_bytes_by_tree": args,
            "output_bytes": None, "generated_code_bytes": None,
        },
        "flops": {"total": m["flops"], "aten": m["aten_flops"],
                  "kernels": m["kernel_flops"]},
        "bytes_accessed": m["bytes_accessed"],
        "roofline": roof.to_dict(),
        "collectives": coll,
    }
    if probe:
        res["probe"] = m["probe"]
    else:
        res["collectives"]["calls"] = _calls(m["log"])
    if extra:
        res["extra"] = extra
    return res


def _calls(log: list) -> dict:
    """The log's collectives counted by (op, axis)."""
    out: dict = {}
    for op, axis, *_ in log:
        key = f"{op}/{axis if isinstance(axis, str) else ','.join(axis)}"
        out[key] = out.get(key, 0) + 1
    return out


def run_cells(cells, mesh_kind: str, *, force: bool = False,
              tag: str = "", probe: str = "auto", loss_block: int = 0,
              kv_int8: bool = False, results=None) -> int:
    """Trace ``cells`` (arch, shape) on the production mesh of
    ``mesh_kind`` ("single", "multi"); the number of cells that
    failed."""
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                stand_in_rank=0)
    out_dir = pathlib.Path(results) if results else RESULTS
    out_dir.mkdir(parents=True, exist_ok=True)
    ok = fail = skip = 0
    for arch_id, shape_name in cells:
        name = f"{arch_id}__{shape_name}__{mesh_kind}" + \
            (f"__{tag}" if tag else "")
        out = out_dir / f"{name}.json"
        applicable, why = cell_applicable(arch_id, shape_name)
        if not applicable:
            out.write_text(json.dumps(
                {"arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
                 "skipped": why}, indent=1))
            obs.log("dryrun.skip", cell=name, why=why)
            skip += 1
            continue
        if out.exists() and not force:
            obs.log("dryrun.cached", cell=name)
            ok += 1
            continue
        try:
            extra = {"kv_cache_dtype": "int8"} if kv_int8 else None
            use_probe = probe == "on" or (
                probe == "auto" and SHAPES[shape_name].kind == "train")
            res = lower_cell(arch_id, shape_name, mesh, extra=extra,
                             loss_block=loss_block, probe=use_probe)
            out.write_text(json.dumps(res, indent=1))
            err = out.with_suffix(".err")
            if err.exists():
                err.unlink()
            r = res["roofline"]
            obs.log("dryrun.ok", cell=name, trace_s=res["lower_s"],
                    mem_gib=round(res["memory"]["bytes_per_device"]
                                  / 2**30, 2),
                    bottleneck=r["bottleneck"],
                    roofline_frac=round(r["roofline_fraction"], 3))
            ok += 1
        except Exception as e:  # noqa: BLE001 -- record, count, go on
            out.with_suffix(".err").write_text(json.dumps(
                {"cell": name, "error": obs.exception_record(e),
                 "traceback": traceback.format_exc()}, indent=1))
            obs.log_exception("dryrun.cell_failed", e, cell=name)
            obs.registry().counter(
                "dryrun.cell_failures",
                "dry-run cells that failed to trace").inc()
            fail += 1
    obs.log("dryrun.done", ok=ok, fail=fail, skip=skip)
    return fail


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--force", action="store_true")
    # JAX's flags, with the one value each that the port runs
    ap.add_argument("--attn-impl", choices=["kernels"], default="kernels",
                    help="the port's serve and score steps run the "
                         "attention kernels, its train step the plain "
                         "attention; JAX's other values are not taken")
    ap.add_argument("--sharded-topk", action="store_true", default=True,
                    help="the port takes the sharded top-K wherever "
                         "'model' cuts the vocabulary")
    ap.add_argument("--no-sharded-topk", action="store_true")
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--loss-block", type=int, default=0)
    ap.add_argument("--tag", default="")
    ap.add_argument("--probe", choices=["auto", "on", "off"],
                    default="auto",
                    help="auto: probes for the train cells, full traces "
                         "for the rest")
    ap.add_argument("--results", default=None,
                    help=f"output directory (default {RESULTS})")
    args = ap.parse_args(argv)
    if not (args.all or args.arch or args.shape):
        ap.error("name --arch and/or --shape, or --all")
    if args.no_sharded_topk:
        ap.error("--no-sharded-topk: the port has no unsharded top-K over "
                 "vocabulary-sharded logits")
    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    cells = [(a, s) for a in archs for s in shapes]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    torch.set_grad_enabled(True)
    rc = 0
    for mk in meshes:
        rc += run_cells(cells, mk, force=args.force, tag=args.tag,
                        probe=args.probe, loss_block=args.loss_block,
                        kv_int8=args.kv_int8, results=args.results)
    raise SystemExit(1 if rc else 0)


if __name__ == "__main__":
    main()
