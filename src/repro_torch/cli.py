"""``llmc-torch`` — command-line front end of the PyTorch port.

    llmc-torch compress   IN OUT [--predictor NAME] [--seed S] [--device D]
                                 [--slots B] [--chunk N] [--topk K]
                                 [--codec rans|ac] [--v3]
                                 [--route llm|auto|zstd|lzma|raw]
                                 [--context-window W] [--shared-prefix F]
                                 [--sidecar] [--trace OUT.json]
    llmc-torch decompress IN OUT [--predictor NAME] [--seed S] [--device D]
                                 [--slots B] [--draft K] [--sidecar]
    llmc-torch range      IN OUT --chunks LO:HI [--predictor NAME]
                                 [--seed S] [--device D] [--slots B]
    llmc-torch info       IN
    llmc-torch stats      [--tokens N] [--format json|prom|text]
                          [--predictor NAME] [--seed S] [--device D]
                          [--chunk N] [--topk K] [--slots B]

The verbs, flags and output are the JAX package's ``llmc``.

``compress``/``decompress`` run through the continuous-batching
``CompressionService`` and write/read v4 seekable containers.
``--codec ac`` and ``--v3`` (the wire-minimal v3 container: no index, no
checksums) take the grouped ``LLMCompressor`` path instead, and a v2/v3
archive decodes there too, at ``--slots`` (default 16): it records no
lane count, and on the card the lane count is coding geometry, so give
``decompress`` the ``--slots`` that ``compress --v3`` had.
``--route`` is the per-chunk codec routing: ``auto`` scores the first 32
tokens of every chunk in one teacher-forced pass (the flash-attention
kernel on the card) and sends each chunk the model fits badly to its
best fallback byte codec; a codec name forces that fallback for every
chunk; both write a v5 mixed-codec container. ``llm`` (the default)
keeps the v4 path.
``--context-window W`` carries each chunk's W-token tail into the next
chunk of its stripe, and ``--shared-prefix FILE`` conditions the
stripe-head chunks on FILE's tokens (jobs that share it restore one
prefilled cache lane from the radix prefix cache); either writes a v6
container, and both need the service path. ``decompress --draft K``
decodes speculatively on the grouped path: a self-draft of K tokens per
lane, one verify program over K + 1 positions, the same bytes.

``range`` decodes the chunk interval [LO, HI) of a v4+ archive (mixed
v5 and carried v6 included) at the container's recorded lane count.
``info`` prints header + index (a v5 archive's codec mix, a v6 archive's
context recipes and shared prefixes) without any model.
An all-fallback archive (``--route raw|lzma|zstd``) decompresses, and a
range of fallback chunks range-decodes, model-free: no predictor is
built, no device is touched, no card is needed.

``stats`` round-trips a small workload (``--tokens`` random tokens,
chunk 64, ``--topk 0``, 8 slots) through a ``CompressionService`` and
prints its telemetry snapshot as JSON, Prometheus text (``--format
prom``) or a human summary (``--format text``). ``--sidecar`` writes a
job's per-chunk diagnostics next to the container as
``<container>.diag.json``. ``compress --trace OUT.json`` records a span
timeline of the run as Chrome-trace JSON and prints the job's phase
breakdown (model / coder / scheduler).

Predictors: ``--predictor`` names a ``pred-*`` predictor or a config of
``configs/registry.py`` (``qwen3-1.7b``, ``h2o-danube-3-4b``,
``deepseek-7b``, ``qwen3-14b``, ``mamba2-130m``, ``zamba2-7b``), on
``--device`` (default ``cuda``; ``cpu`` on request). The int8 KV cache
has no flag, as in the JAX ``llmc``: it is a field of the config
(``get_config(name).with_(kv_cache_dtype="int8")``).

* A ``pred-*`` predictor is **trained**, as the JAX package's ``llmc``
  has it: the first use trains it by the recipe of ``train/prep.py``
  (``--seed`` is the training seed) and saves a checkpoint in the cache
  (``results/torch_cache/`` in the checkout, or ``$REPRO_TORCH_CACHE``);
  every later process loads that checkpoint and never trains again.
* A registered full-width config is a **random init made from
  ``--seed``** (default 0): no trained weights exist for it, and its
  ratios fall below 1.

Decompress needs the same predictor, seed, cache and device as compress:
the engine and its weights are part of the coding geometry.
"""
from __future__ import annotations

import argparse
import sys
import time


def _predictor(args):
    from repro_torch.configs.registry import PREDICTORS, get_config
    from repro_torch.device import resolve_device
    from repro_torch.serve.engine import ModelPredictor
    cfg = get_config(args.predictor)
    resolve_device(args.device)             # no card: raise before training
    if args.predictor in PREDICTORS:
        from repro_torch.train.prep import predictor
        return predictor(args.predictor, seed=args.seed, device=args.device)
    print(f"llmc-torch: note: {args.predictor} runs with UNTRAINED random "
          f"weights (seed {args.seed}); expect ratios below 1",
          file=sys.stderr)
    return ModelPredictor.random_init(cfg, seed=args.seed,
                                      device=args.device)


def _cmd_info(args) -> int:
    from repro_torch.core import read_header, read_index
    from repro_torch.core.compressor import (VERSION_V4, VERSION_V5,
                                             VERSION_V6)
    blob = open(args.input, "rb").read()
    info = read_header(blob)
    print(f"{args.input}: LLMC v{info.version} codec={info.codec_name} "
          f"chunk_size={info.chunk_size} n_tokens={info.n_tokens} "
          f"n_chunks={info.n_chunks} vocab={info.vocab} topk={info.topk} "
          f"precision={info.precision} ({len(blob)} bytes)")
    if info.version < VERSION_V4:
        print("index: none (v2/v3 container — no random access)")
        return 0
    info = read_index(blob, info)
    tagged = info.version >= VERSION_V5
    ctxed = info.version >= VERSION_V6
    cols = "offset, bytes, tokens, xxh64" + (", codec" if tagged else "") \
        + (", context" if ctxed else "")
    budget = f" ctx_budget={info.ctx_budget};" if ctxed else ""
    print(f"index: footer verified; encode_batch={info.encode_batch};"
          f"{budget} per-chunk ({cols}):")
    for i, e in enumerate(info.entries):
        tag = f"  {e.codec_name}" if tagged else ""
        rec = f"  {e.recipe_name}" if ctxed else ""
        print(f"  chunk {i:4d}: {e.offset:8d} {e.length:6d} "
              f"{e.n_tokens:5d} {e.checksum:016x}{tag}{rec}")
    if tagged:
        print(_mix("codecs", [e.codec_name for e in info.entries]))
    if ctxed:
        print(_mix("contexts", [e.recipe_name.split("(")[0].split("[")[0]
                                for e in info.entries]))
        for j, (name, toks) in enumerate(info.shared_prefixes):
            print(f"shared prefix [{j}]: {name!r} ({len(toks)} tokens)")
        if not info.shared_prefixes:
            print("shared prefixes: none")
    return 0


def _mix(label: str, names: list[str]) -> str:
    """``label: 3×rans  1×raw`` — how many chunks carry each name."""
    counts: dict[str, int] = {}
    for n in names:
        counts[n] = counts.get(n, 0) + 1
    mix = "  ".join(f"{n}×{c}" for c, n in sorted(counts.items()))
    return f"{label}: {mix}" if mix else f"{label}: (empty)"


def _service(args, pred):
    from repro_torch.core.cdf import DEFAULT_PRECISION
    from repro_torch.service import CompressionService
    return CompressionService(pred, slots=args.slots, chunk_size=args.chunk,
                              topk=args.topk,
                              precision=getattr(args, "precision",
                                                DEFAULT_PRECISION),
                              route=getattr(args, "route", "llm"),
                              trace=getattr(args, "trace", None) or None,
                              device=args.device)


def _print_phases(rep) -> None:
    """One line: the job's wall time split into phases."""
    if rep is None:
        return
    parts = "  ".join(f"{k}={v * 1e3:.1f}ms"
                      for k, v in sorted(rep.phases.items()) if v > 0)
    print(f"phases ({rep.total_s * 1e3:.0f}ms wall, coverage "
          f"{rep.coverage:.0%}): {parts}")


def _cmd_compress(args) -> int:
    from repro_torch import obs
    from repro_torch.core import LLMCompressor
    from repro_torch.data.tokenizer import encode
    args.slots = args.slots or 16
    if args.codec == "ac" or args.v3:
        if args.route != "llm":
            # routing needs v5 codec tags; v3 cannot carry them and the
            # ac path never routes
            raise SystemExit("llmc-torch: --route requires the default "
                             "service path (rans codec, no --v3)")
        if args.context_window or args.shared_prefix:
            raise SystemExit("llmc-torch: context options need the default "
                             "service path (rans codec, no --v3) — they "
                             "write a v6 container")
    pred = _predictor(args)
    data = open(args.input, "rb").read()
    toks = encode(data)
    sp = encode(open(args.shared_prefix, "rb").read()) \
        if args.shared_prefix else None
    t0 = time.time()
    handle = svc = rec = None
    if args.codec == "ac" or args.v3:
        # the ac codec and the wire-minimal v3 container: grouped path
        if args.trace:
            rec = obs.TimelineRecorder()
            obs.timeline.install(rec)
        comp = LLMCompressor(pred, chunk_size=args.chunk, topk=args.topk,
                             decode_batch=args.slots, codec=args.codec,
                             container_version=3 if args.v3 else 4)
        try:
            blob, stats = comp.compress(toks)
        finally:
            if rec is not None and obs.timeline.active() is rec:
                obs.timeline.uninstall()
    else:
        svc = _service(args, pred)
        handle = svc.submit_compress(
            toks, shared_prefix=sp, context_window=args.context_window)
        blob, stats = handle.result()
    open(args.output, "wb").write(blob)
    if args.trace:
        if svc is not None:
            # the report reads the recorder, which close() detaches
            rep = handle.phase_report()
            path = svc.write_timeline()
            svc.close()
        else:
            rec.save(args.trace)
            path = args.trace
            rep = obs.PhaseReport.from_recorder(rec)
        print(f"timeline -> {path} (Chrome-trace JSON; load in "
              f"chrome://tracing or ui.perfetto.dev)")
        _print_phases(rep)
    if args.sidecar:
        if handle is not None:
            path = handle.write_sidecar(args.output)
        else:   # grouped path: per-chunk diagnostics ride on stats.chunks
            path = obs.write_sidecar(args.output, obs.JobDiagnostics(
                kind="compress", codec=args.codec, n_tokens=stats.n_tokens,
                container_bytes=len(blob), chunks=stats.chunks))
        print(f"diagnostics -> {path}")
    print(f"{len(data)}B -> {len(blob)}B "
          f"({len(data) / max(1, len(blob)):.2f}x, "
          f"{stats.n_tokens} tokens, {time.time() - t0:.1f}s)")
    return 0


def _cmd_decompress(args) -> int:
    from repro_torch.core import (LLMCompressor, container_is_model_free,
                                  decompress_model_free, read_header,
                                  read_index)
    from repro_torch.data.tokenizer import decode
    blob = open(args.input, "rb").read()
    info = read_header(blob)
    if info.version >= 4:
        info = read_index(blob, info)
        if container_is_model_free(info):
            # every chunk is fallback-coded: no predictor, no device
            t0 = time.time()
            toks = decompress_model_free(blob)
            open(args.output, "wb").write(decode(toks))
            print(f"{len(blob)}B -> decoded {toks.size} tokens "
                  f"(model-free, {time.time() - t0:.1f}s)")
            return 0
    args.chunk, args.topk = info.chunk_size, info.topk
    args.precision = info.precision
    args.slots = args.slots or info.encode_batch or 16
    pred = _predictor(args)
    t0 = time.time()
    handle = None
    if info.codec_name == "ac" or args.draft or info.version < 4:
        # the ac codec has no service path; --draft decodes speculatively
        # on the grouped path (the same tokens, fewer model programs on
        # predictable text); a v2/v3 archive records no lane count, and
        # the grouped path that wrote it ran min(slots, chunks) lanes: on
        # the card the logits depend on the lane count, so it decodes
        # there, at the same count
        comp = LLMCompressor(pred, chunk_size=args.chunk, topk=args.topk,
                             precision=args.precision,
                             codec=info.codec_name, decode_batch=args.slots,
                             draft_k=args.draft)
        toks = comp.decompress(blob)
    else:
        handle = _service(args, pred).submit_decompress(blob)
        toks = handle.result()
    if args.sidecar:
        if handle is not None:
            print(f"diagnostics -> {handle.write_sidecar(args.input)}")
        else:
            print("llmc-torch: note: --sidecar needs the service decode "
                  "path (rans codec, no --draft); skipped", file=sys.stderr)
    open(args.output, "wb").write(decode(toks))
    print(f"{len(blob)}B -> decoded {toks.size} tokens "
          f"({time.time() - t0:.1f}s)")
    return 0


def _cmd_range(args) -> int:
    from repro_torch.core import (ContainerError, LLMCompressor,
                                  decompress_range_model_free, read_index)
    from repro_torch.data.tokenizer import decode
    blob = open(args.input, "rb").read()
    try:
        lo, hi = (int(x) for x in args.chunks.split(":"))
    except ValueError:
        raise SystemExit(f"llmc-torch: --chunks expects LO:HI integers, "
                         f"got {args.chunks!r}")
    t0 = time.time()
    try:
        info = read_index(blob)
        if 0 <= lo < hi <= len(info.entries) \
                and all(not e.is_llm for e in info.entries[lo:hi]):
            # every requested chunk is fallback-coded (their recipes are
            # none by format law): no predictor, no device
            toks = decompress_range_model_free(blob, lo, hi)
            how = "model-free, "
        else:
            if args.slots and info.encode_batch \
                    and args.slots != info.encode_batch:
                print(f"llmc-torch: note: range decode runs at the "
                      f"container's recorded encode batch "
                      f"({info.encode_batch}); --slots {args.slots} "
                      f"ignored", file=sys.stderr)
            pred = _predictor(args)
            t0 = time.time()
            comp = LLMCompressor(
                pred, chunk_size=info.chunk_size, topk=info.topk,
                precision=info.precision,
                decode_batch=args.slots or info.encode_batch or 16)
            toks = comp.decompress_range(blob, lo, hi)
            how = ""
    except ContainerError as e:
        # empty, reversed and out-of-bounds ranges and corrupt containers
        # all arrive here with a precise message
        raise SystemExit(f"llmc-torch: {e}")
    open(args.output, "wb").write(decode(toks))
    print(f"chunks [{lo}, {hi}) -> {toks.size} tokens "
          f"({how}{time.time() - t0:.1f}s)")
    return 0


def _cmd_stats(args) -> int:
    """Round-trip a small workload through a CompressionService and print
    its telemetry snapshot."""
    import json

    import numpy as np
    pred = _predictor(args)
    svc = _service(args, pred)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, max(2, pred.vocab_size - 1), args.tokens,
                        dtype=np.int32)
    blob, _ = svc.submit_compress(toks).result()
    rt = svc.submit_decompress(blob).result()
    if not np.array_equal(rt, toks):
        raise SystemExit("llmc-torch: stats round-trip mismatch (BUG)")
    snap = svc.snapshot()
    if args.format == "prom":
        sys.stdout.write(svc.registry.to_prometheus())
    elif args.format == "text":
        sched = snap["scheduler"]
        bpt = snap["chunk_bits_per_token"] or {}
        print(f"workload: {args.tokens} tokens round-tripped "
              f"({len(blob)} container bytes)")
        print(f"occupancy {snap['occupancy']:.3f}  model_steps "
              f"{sched['model_steps']}  chunks {sched['chunks_completed']}"
              f"  refills {sched['refills']}  failures "
              f"{sched['chunk_failures']}")
        if bpt:
            print(f"bits/token: mean {bpt['mean']:.2f}  p50 {bpt['p50']:g}"
                  f"  p95 {bpt['p95']:g}  p99 {bpt['p99']:g}  "
                  f"({bpt['count']} chunks)")
        acc = snap["draft_acceptance"]
        print(f"draft acceptance: "
              f"{'n/a (no speculative decode)' if acc is None else acc}")
        print(f"jobs: {snap['jobs']}")
        phases = {k: v for k, v in (snap.get("phases") or {}).items()
                  if v > 0}
        if phases:
            print("phase seconds: " + "  ".join(
                f"{k}={v:.3f}" for k, v in sorted(phases.items())))
    else:
        print(json.dumps(snap, indent=1, default=str))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="llmc-torch",
        description="LLM next-token-prediction compressor (PyTorch port)",
        epilog="pred-* predictors are trained at first use and loaded from "
               "the cache (results/torch_cache/ in the checkout, or "
               "$REPRO_TORCH_CACHE) ever after; registered configs "
               "(qwen3-1.7b, h2o-danube-3-4b, deepseek-7b, qwen3-14b, "
               "mamba2-130m, zamba2-7b) are random weights from --seed.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def model_args(p, slots=None):
        p.add_argument("--predictor", default="pred-base",
                       help="pred-* predictor (trained at first use and "
                            "cached) or registered config name (random "
                            "weights)")
        p.add_argument("--seed", type=int, default=0,
                       help="training seed of a pred-* predictor; seed of "
                            "a registered config's random weights")
        p.add_argument("--device", default="cuda",
                       help="torch device (default cuda; cpu on request)")
        # default: 16 for compress; for decompress and range, the v4
        # container's recorded encode batch (the batch shape is coding
        # geometry)
        p.add_argument("--slots", type=int, default=slots)

    p = sub.add_parser("compress", help="file -> .llmc container")
    p.add_argument("input")
    p.add_argument("output")
    model_args(p)
    p.add_argument("--codec", choices=("rans", "ac"), default="rans")
    p.add_argument("--chunk", type=int, default=128)
    p.add_argument("--topk", type=int, default=48)
    p.add_argument("--v3", action="store_true",
                   help="write the wire-minimal v3 container (no index, "
                        "no checksums; grouped path)")
    p.add_argument("--route", choices=("llm", "auto", "zstd", "lzma", "raw"),
                   default="llm",
                   help="per-chunk codec routing: 'auto' probes model fit "
                        "per chunk and writes a v5 mixed-codec container; "
                        "a codec name forces that fallback for every "
                        "chunk; 'llm' (default) keeps the v4 path")
    p.add_argument("--sidecar", action="store_true",
                   help="write per-chunk diagnostics (bits/token, escapes) "
                        "to OUT.diag.json")
    p.add_argument("--context-window", type=int, default=0, metavar="W",
                   help="carry each chunk's W-token tail into the next "
                        "chunk of its stripe (a v6 container with "
                        "per-chunk context recipes)")
    p.add_argument("--shared-prefix", default="", metavar="FILE",
                   help="condition stripe-head chunks on FILE's tokens as "
                        "a named shared prefix (v6; jobs sharing the "
                        "prefix restore one prefilled cache lane)")
    p.add_argument("--trace", default="", metavar="OUT.json",
                   help="record a span timeline of the run as Chrome-trace "
                        "JSON (chrome://tracing, ui.perfetto.dev) and print "
                        "the job's phase breakdown")
    p.set_defaults(fn=_cmd_compress)

    p = sub.add_parser("decompress", help=".llmc container -> file")
    p.add_argument("input")
    p.add_argument("output")
    model_args(p)
    p.add_argument("--draft", type=int, default=0, metavar="K",
                   help="speculative decode on the grouped path: self-"
                        "draft K tokens per verify program (0 = the "
                        "service's lock-step)")
    p.add_argument("--sidecar", action="store_true",
                   help="write per-chunk diagnostics to IN.diag.json "
                        "(service path only)")
    p.set_defaults(fn=_cmd_decompress)

    p = sub.add_parser("range", help="random-access decode of chunks "
                                     "[LO, HI) (v4+ containers)")
    p.add_argument("input")
    p.add_argument("output")
    model_args(p)
    p.add_argument("--chunks", required=True, metavar="LO:HI")
    p.set_defaults(fn=_cmd_range)

    p = sub.add_parser("info", help="print header + index (no model)")
    p.add_argument("input")
    p.set_defaults(fn=_cmd_info)

    p = sub.add_parser(
        "stats", help="run a sample workload, print service telemetry")
    model_args(p, slots=8)
    p.add_argument("--tokens", type=int, default=2048,
                   help="workload size in tokens (default 2048)")
    p.add_argument("--chunk", type=int, default=64)
    p.add_argument("--topk", type=int, default=0)
    p.add_argument("--format", choices=("json", "prom", "text"),
                   default="json",
                   help="snapshot format: structured JSON (default), "
                        "Prometheus text exposition, or human summary")
    p.set_defaults(fn=_cmd_stats)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
