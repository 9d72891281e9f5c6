"""``llmc-torch`` — command-line front end of the PyTorch port.

    llmc-torch compress   IN OUT [--predictor NAME] [--seed S] [--device D]
                                 [--slots B] [--chunk N] [--topk K]
                                 [--codec rans|ac]
                                 [--route llm|auto|zstd|lzma|raw]
                                 [--context-window W] [--shared-prefix F]
    llmc-torch decompress IN OUT [--predictor NAME] [--seed S] [--device D]
                                 [--slots B] [--draft K]
    llmc-torch info       IN

``compress``/``decompress`` run through the continuous-batching
``CompressionService`` and write/read v4 seekable containers, as the
JAX package's ``llmc`` does (``--codec ac`` takes the grouped path).
``--route`` is the per-chunk codec routing of the JAX CLI: ``auto``
scores the first 32 tokens of every chunk in one teacher-forced pass (the
flash-attention kernel on the card) and sends each chunk the model fits
badly to its best fallback byte codec; a codec name forces that fallback
for every chunk; both write a v5 mixed-codec container. ``llm`` (the
default) keeps the v4 path.
``--context-window W`` carries each chunk's W-token tail into the next
chunk of its stripe, and ``--shared-prefix FILE`` conditions the
stripe-head chunks on FILE's tokens (jobs that share it restore one
prefilled cache lane from the radix prefix cache); either writes a v6
container, and both need the service path. ``decompress --draft K``
decodes speculatively on the grouped path: a self-draft of K tokens per
lane, one verify program over K + 1 positions, the same bytes.
``info`` prints header + index (and a v6 container's context recipes and
shared prefixes) without any model.

Predictors: ``--predictor`` names a ``pred-*`` predictor or a registered
config (``qwen3-1.7b``, ``mamba2-130m``), on ``--device`` (default
``cuda``; ``cpu`` on request).

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
    if info.version >= VERSION_V4:
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
        if ctxed:
            counts = {}
            for e in info.entries:
                name = e.recipe_name.split("(")[0].split("[")[0]
                counts[name] = counts.get(name, 0) + 1
            mix = "  ".join(f"{n}×{r}" for r, n in sorted(counts.items()))
            print(f"contexts: {mix}" if mix else "contexts: (empty)")
            for j, (name, toks) in enumerate(info.shared_prefixes):
                print(f"shared prefix [{j}]: {name!r} ({len(toks)} tokens)")
            if not info.shared_prefixes:
                print("shared prefixes: none")
    else:
        print("index: none (v2/v3 container — no random access)")
    return 0


def _service(args, pred, chunk, topk, precision):
    from repro_torch.service import CompressionService
    return CompressionService(pred, slots=args.slots, chunk_size=chunk,
                              topk=topk, precision=precision,
                              route=getattr(args, "route", "llm"),
                              device=args.device)


def _cmd_compress(args) -> int:
    from repro_torch.core import LLMCompressor
    from repro_torch.core.cdf import DEFAULT_PRECISION
    from repro_torch.data.tokenizer import encode
    args.slots = args.slots or 16
    if args.codec == "ac" and args.route != "llm":
        # routing needs v5 codec tags, which the ac path never writes
        raise SystemExit("llmc-torch: --route requires the default "
                         "service path (rans codec)")
    if args.codec == "ac" and (args.context_window or args.shared_prefix):
        raise SystemExit("llmc-torch: context options need the default "
                         "service path (rans codec): they write a v6 "
                         "container")
    pred = _predictor(args)
    data = open(args.input, "rb").read()
    toks = encode(data)
    sp = encode(open(args.shared_prefix, "rb").read()) \
        if args.shared_prefix else None
    t0 = time.time()
    if args.codec == "ac":
        comp = LLMCompressor(pred, chunk_size=args.chunk, topk=args.topk,
                             decode_batch=args.slots, codec="ac",
                             container_version=4)
        blob, stats = comp.compress(toks)
    else:
        svc = _service(args, pred, args.chunk, args.topk, DEFAULT_PRECISION)
        blob, stats = svc.submit_compress(
            toks, shared_prefix=sp,
            context_window=args.context_window).result()
    open(args.output, "wb").write(blob)
    print(f"{len(data)}B -> {len(blob)}B "
          f"({len(data) / max(1, len(blob)):.2f}x, "
          f"{stats.n_tokens} tokens, {time.time() - t0:.1f}s)")
    return 0


def _cmd_decompress(args) -> int:
    from repro_torch.core import LLMCompressor, read_header, read_index
    from repro_torch.data.tokenizer import decode
    blob = open(args.input, "rb").read()
    info = read_header(blob)
    if info.version >= 4:
        info = read_index(blob, info)
    args.slots = args.slots or info.encode_batch or 16
    pred = _predictor(args)
    t0 = time.time()
    if info.codec_name == "ac" or args.draft:
        # the ac codec has no service path; --draft decodes speculatively
        # on the grouped path (the same tokens, fewer model programs on
        # predictable text)
        comp = LLMCompressor(pred, chunk_size=info.chunk_size,
                             topk=info.topk, precision=info.precision,
                             codec=info.codec_name, decode_batch=args.slots,
                             draft_k=args.draft)
        toks = comp.decompress(blob)
    else:
        svc = _service(args, pred, info.chunk_size, info.topk,
                       info.precision)
        toks = svc.submit_decompress(blob).result()
    open(args.output, "wb").write(decode(toks))
    print(f"{len(blob)}B -> decoded {toks.size} tokens "
          f"({time.time() - t0:.1f}s)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="llmc-torch",
        description="LLM next-token-prediction compressor (PyTorch port)",
        epilog="pred-* predictors are trained at first use and loaded from "
               "the cache (results/torch_cache/ in the checkout, or "
               "$REPRO_TORCH_CACHE) ever after; registered configs "
               "(qwen3-1.7b, mamba2-130m) are random weights from --seed.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def model_args(p):
        p.add_argument("--predictor", default="pred-base",
                       help="pred-* predictor (trained at first use and "
                            "cached) or registered config name (random "
                            "weights)")
        p.add_argument("--seed", type=int, default=0,
                       help="training seed of a pred-* predictor; seed of "
                            "a registered config's random weights")
        p.add_argument("--device", default="cuda",
                       help="torch device (default cuda; cpu on request)")
        # default: 16 for compress; for decompress, the v4 container's
        # recorded encode batch (the batch shape is coding geometry)
        p.add_argument("--slots", type=int, default=None)

    p = sub.add_parser("compress", help="file -> .llmc container")
    p.add_argument("input")
    p.add_argument("output")
    model_args(p)
    p.add_argument("--codec", choices=("rans", "ac"), default="rans")
    p.add_argument("--chunk", type=int, default=128)
    p.add_argument("--topk", type=int, default=48)
    p.add_argument("--route", choices=("llm", "auto", "zstd", "lzma", "raw"),
                   default="llm",
                   help="per-chunk codec routing: 'auto' probes model fit "
                        "per chunk and writes a v5 mixed-codec container; "
                        "a codec name forces that fallback for every "
                        "chunk; 'llm' (default) keeps the v4 path")
    p.add_argument("--context-window", type=int, default=0, metavar="W",
                   help="carry each chunk's W-token tail into the next "
                        "chunk of its stripe (a v6 container with "
                        "per-chunk context recipes)")
    p.add_argument("--shared-prefix", default="", metavar="FILE",
                   help="condition stripe-head chunks on FILE's tokens as "
                        "a named shared prefix (v6; jobs sharing the "
                        "prefix restore one prefilled cache lane)")
    p.set_defaults(fn=_cmd_compress)

    p = sub.add_parser("decompress", help=".llmc container -> file")
    p.add_argument("input")
    p.add_argument("output")
    model_args(p)
    p.add_argument("--draft", type=int, default=0, metavar="K",
                   help="speculative decode on the grouped path: self-"
                        "draft K tokens per verify program (0 = the "
                        "service's lock-step)")
    p.set_defaults(fn=_cmd_decompress)

    p = sub.add_parser("info", help="print header + index (no model)")
    p.add_argument("input")
    p.set_defaults(fn=_cmd_info)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
