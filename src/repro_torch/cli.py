"""``llmc-torch`` — command-line front end of the PyTorch port.

    llmc-torch compress   IN OUT [--predictor NAME] [--seed S] [--device D]
                                 [--slots B] [--chunk N] [--topk K]
                                 [--codec rans|ac]
    llmc-torch decompress IN OUT [--predictor NAME] [--seed S] [--device D]
                                 [--slots B]
    llmc-torch info       IN

``compress``/``decompress`` run through the continuous-batching
``CompressionService`` and write/read v4 seekable containers, as the
JAX package's ``llmc`` does (``--codec ac`` takes the grouped path).
``info`` prints header + index without any model.

Predictors: ``--predictor`` names a ``pred-*`` predictor or a registered
config (``qwen3-1.7b``); the port has no trained weights yet, so the
model is a **random init made from ``--seed``** (default 0), on
``--device`` (default ``cuda``; ``cpu`` on request). Decompress needs the
same predictor, seed and device as compress: the engine and its weights
are part of the coding geometry.
"""
from __future__ import annotations

import argparse
import sys
import time


def _predictor(args):
    from repro_torch.configs.registry import get_config
    from repro_torch.serve.engine import ModelPredictor
    cfg = get_config(args.predictor)
    print(f"llmc-torch: note: {args.predictor} runs with UNTRAINED random "
          f"weights (seed {args.seed}); expect ratios below 1",
          file=sys.stderr)
    return ModelPredictor.random_init(cfg, seed=args.seed,
                                      device=args.device)


def _cmd_info(args) -> int:
    from repro_torch.core import read_header, read_index
    from repro_torch.core.compressor import VERSION_V4, VERSION_V5
    blob = open(args.input, "rb").read()
    info = read_header(blob)
    print(f"{args.input}: LLMC v{info.version} codec={info.codec_name} "
          f"chunk_size={info.chunk_size} n_tokens={info.n_tokens} "
          f"n_chunks={info.n_chunks} vocab={info.vocab} topk={info.topk} "
          f"precision={info.precision} ({len(blob)} bytes)")
    if info.version >= VERSION_V4:
        info = read_index(blob, info)
        tagged = info.version >= VERSION_V5
        print(f"index: footer verified; encode_batch={info.encode_batch}; "
              f"per-chunk (offset, bytes, tokens, xxh64"
              f"{', codec' if tagged else ''}):")
        for i, e in enumerate(info.entries):
            tag = f"  {e.codec_name}" if tagged else ""
            print(f"  chunk {i:4d}: {e.offset:8d} {e.length:6d} "
                  f"{e.n_tokens:5d} {e.checksum:016x}{tag}")
    else:
        print("index: none (v2/v3 container — no random access)")
    return 0


def _service(args, pred, chunk, topk, precision):
    from repro_torch.service import CompressionService
    return CompressionService(pred, slots=args.slots, chunk_size=chunk,
                              topk=topk, precision=precision,
                              device=args.device)


def _cmd_compress(args) -> int:
    from repro_torch.core import LLMCompressor
    from repro_torch.core.cdf import DEFAULT_PRECISION
    from repro_torch.data.tokenizer import encode
    args.slots = args.slots or 16
    pred = _predictor(args)
    data = open(args.input, "rb").read()
    toks = encode(data)
    t0 = time.time()
    if args.codec == "ac":
        comp = LLMCompressor(pred, chunk_size=args.chunk, topk=args.topk,
                             decode_batch=args.slots, codec="ac",
                             container_version=4)
        blob, stats = comp.compress(toks)
    else:
        svc = _service(args, pred, args.chunk, args.topk, DEFAULT_PRECISION)
        blob, stats = svc.submit_compress(toks).result()
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
    if info.codec_name == "ac":
        comp = LLMCompressor(pred, chunk_size=info.chunk_size,
                             topk=info.topk, precision=info.precision,
                             codec="ac", decode_batch=args.slots)
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
        description="LLM next-token-prediction compressor (PyTorch port)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def model_args(p):
        p.add_argument("--predictor", default="pred-base",
                       help="pred-* predictor or registered config name")
        p.add_argument("--seed", type=int, default=0,
                       help="seed of the random-init weights")
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
    p.set_defaults(fn=_cmd_compress)

    p = sub.add_parser("decompress", help=".llmc container -> file")
    p.add_argument("input")
    p.add_argument("output")
    model_args(p)
    p.set_defaults(fn=_cmd_decompress)

    p = sub.add_parser("info", help="print header + index (no model)")
    p.add_argument("input")
    p.set_defaults(fn=_cmd_info)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
