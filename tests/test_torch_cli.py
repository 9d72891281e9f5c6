"""``llmc-torch`` against the JAX package's ``llmc``, verb by verb.

Both CLIs run in this process on the same inputs, their ``_predictor``
monkeypatched to a ``GoldenPredictor(vocab_size=258)`` (the table
predictor both packages accept), the port with ``--device cpu``:

* the all-fallback ``--route raw`` / ``--route lzma`` archives are
  byte-identical between the CLIs, and each CLI decodes the other's;
* ``--topk 0`` archives (plain and ``--v3``) have the same header, the
  same chunks and the same stream bytes in every chunk whose tokens
  meet no CDF point that ROADMAP P1 moves: XLA's float32 ``exp`` differs
  from torch's in the last bit for ~10% of the 258 x 258 table, which
  moves 46 of its rows' full-vocabulary CDFs by one quantum at a point or
  two. A chunk whose coded interval touches such a point codes other
  bytes (on the 700-byte input, chunk 8 of 11); the archives are equal
  byte for byte only where no chunk does;
* ``info`` prints the same text for every golden container and for the
  port's archives, apart from the path in the first line (F6: the codec
  mix of a v5/v6 archive);
* ``range`` gives the source's byte slice in both, and JAX's errors on
  an empty range, an out-of-bounds range and a malformed ``LO:HI``;
* ``stats`` agrees with JAX's snapshot (scheduler counters,
  bits/token, occupancy, jobs), Prometheus text and summary, apart from
  time-valued series;
* ``--sidecar`` JSON agrees apart from ``wall_s`` and ``phases`` (and the
  float64 model cross-entropy ``ideal_bits``, summed in another order,
  to 1e-12), and the ``--trace`` timeline has JAX's span names, plus the
  port scheduler's ``coder.step`` (the coder phase of its phase report);
* ``--v3 --route`` and ``--v3 --context-window`` are refused with JAX's
  messages;
* an all-fallback archive decompresses, and a fallback range
  range-decodes, with no predictor built and no device asked for (F7).
"""
import json
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from helpers import GoldenPredictor  # noqa: E402
from repro import cli as jcli  # noqa: E402
from repro.core import cdf as jcdf  # noqa: E402
from repro_torch import cli as pcli  # noqa: E402
from repro_torch.core import cdf as pcdf  # noqa: E402
from repro_torch.core.compressor import parse_container  # noqa: E402

GOLDEN = pathlib.Path(__file__).parent / "golden"
DATA = np.random.default_rng(5).integers(0, 256, 700, dtype=np.uint8) \
    .tobytes()


@pytest.fixture
def both(monkeypatch, capsys):
    """run(which, argv) -> stdout, with both CLIs on table predictors."""
    monkeypatch.setattr(jcli, "_predictor",
                        lambda name: GoldenPredictor(vocab_size=258))
    monkeypatch.setattr(pcli, "_predictor",
                        lambda args: GoldenPredictor(vocab_size=258))

    def run(which, argv):
        capsys.readouterr()
        if which == "jax":
            assert jcli.main(argv) == 0
        else:
            assert pcli.main(argv + _device(argv)) == 0
        return capsys.readouterr().out
    return run


def _device(argv):
    return [] if argv[0] == "info" else ["--device", "cpu"]


def _src(tmp_path, data=DATA):
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    return src


def _without_path(out: str) -> str:
    first, _, rest = out.partition("\n")
    return first.partition(": ")[2] + "\n" + rest


def _without_timing(out: str) -> str:
    return re.sub(r"\d+\.\d+s\)", "_s)", out)


# ------------------------------------------------------------ archives
def _p1_chunks(data: bytes, C: int) -> set:
    """Chunks of ``data`` in which some token's CDF interval under the
    table differs between the packages' full-vocabulary CDFs (P1)."""
    table = GoldenPredictor(vocab_size=258)._table
    j = np.asarray(jcdf.full_cdf_jit(jnp.asarray(table), 16))
    p = pcdf.to_numpy(pcdf.full_cdf(table, 16))
    toks = np.frombuffer(data, np.uint8).astype(np.int64)
    out = set()
    for i in range(0, toks.size, C):
        t = toks[i:i + C]
        prev = np.concatenate([[table.shape[0] - 1], t[:-1]])
        if ((j[prev, t] != p[prev, t]) | (j[prev, t + 1] != p[prev, t + 1])
                ).any():
            out.add(i // C)
    return out


@pytest.mark.parametrize("flags", [
    ["--route", "raw", "--chunk", "64"],
    ["--route", "lzma", "--chunk", "64"],
], ids=["raw", "lzma"])
def test_fallback_archives_are_byte_identical(both, tmp_path, flags):
    src = _src(tmp_path)
    blobs = {}
    for which in ("jax", "torch"):
        arc = tmp_path / f"{which}.llmc"
        out = both(which, ["compress", str(src), str(arc), *flags])
        assert re.search(r"700B -> \d+B", out)
        blobs[which] = arc.read_bytes()
    assert blobs["torch"] == blobs["jax"] and blobs["torch"][4] == 5
    for which, other in (("jax", "torch"), ("torch", "jax")):
        back = tmp_path / f"{which}.out"
        both(which, ["decompress", str(tmp_path / f"{other}.llmc"),
                     str(back)])
        assert back.read_bytes() == DATA


@pytest.mark.parametrize("flags", [[], ["--v3"]], ids=["v4", "v3"])
def test_topk0_archives_agree_chunk_by_chunk(both, tmp_path, flags):
    src = _src(tmp_path)
    blobs = {}
    for which in ("jax", "torch"):
        arc, back = tmp_path / f"{which}.llmc", tmp_path / f"{which}.out"
        both(which, ["compress", str(src), str(arc), "--topk", "0",
                     "--chunk", "64", "--slots", "8", *flags])
        blobs[which] = arc.read_bytes()
        both(which, ["decompress", str(arc), str(back)])
        assert back.read_bytes() == DATA
    (jinfo, js), (pinfo, ps) = (parse_container(blobs[w])
                                for w in ("jax", "torch"))
    assert pinfo.version == jinfo.version == (3 if flags else 4)
    assert blobs["torch"][:pinfo.header_size] \
        == blobs["jax"][:jinfo.header_size]
    assert [e.n_tokens for e in pinfo.entries] \
        == [e.n_tokens for e in jinfo.entries]
    moved = _p1_chunks(DATA, 64)
    assert len(moved) < len(ps) // 2        # the comparison bites
    for i, (a, b) in enumerate(zip(ps, js)):
        if i not in moved:
            assert a == b, f"chunk {i} differs and meets no P1 point"
    if not moved:
        assert blobs["torch"] == blobs["jax"]


# ---------------------------------------------------------------- info (F6)
@pytest.mark.parametrize("name", sorted(p.name
                                        for p in GOLDEN.glob("*.llmc")))
def test_info_prints_what_jax_prints(both, name):
    path = str(GOLDEN / name)
    jout, pout = both("jax", ["info", path]), both("torch", ["info", path])
    assert _without_path(pout) == _without_path(jout)
    if name.startswith(("v5", "v6")):
        assert "\ncodecs: " in pout


@pytest.mark.parametrize("flags", [
    ["--route", "raw"], ["--route", "auto"],
    ["--context-window", "8", "--slots", "2"], ["--topk", "8"]],
    ids=["raw", "auto", "carry", "v4"])
def test_info_of_port_archives_matches_jax(both, tmp_path, flags):
    src = _src(tmp_path, DATA[:200])
    arc = tmp_path / "a.llmc"
    both("torch", ["compress", str(src), str(arc), "--chunk", "16", *flags])
    jout = both("jax", ["info", str(arc)])
    assert both("torch", ["info", str(arc)]) == jout


# ----------------------------------------------------------------- range
@pytest.mark.parametrize("route", ["llm", "raw"])
def test_range_gives_the_source_slice_in_both(both, tmp_path, route):
    src = _src(tmp_path)
    arc = tmp_path / "a.llmc"
    both("torch", ["compress", str(src), str(arc), "--chunk", "64",
                   "--topk", "0", "--route", route])
    outs = {}
    for which in ("jax", "torch"):
        part = tmp_path / f"{which}.part"
        outs[which] = both(which, ["range", str(arc), str(part),
                                   "--chunks", "2:5"])
        assert part.read_bytes() == DATA[128:320]
    assert _without_timing(outs["torch"]) == _without_timing(outs["jax"])
    assert ("model-free" in outs["torch"]) == (route == "raw")


def test_range_errors_are_jax_errors(both, tmp_path):
    src = _src(tmp_path, bytes(range(100)))
    arc, out = tmp_path / "a.llmc", tmp_path / "out.bin"
    both("torch", ["compress", str(src), str(arc), "--chunk", "16",
                   "--topk", "8"])
    for chunks in ("2:2", "0:99", "3:1", "nope"):
        msgs = []
        for cli, extra in ((jcli, []), (pcli, ["--device", "cpu"])):
            with pytest.raises(SystemExit) as e:
                cli.main(["range", str(arc), str(out), "--chunks", chunks,
                          *extra])
            msgs.append(str(e.value).split(": ", 1))
        assert msgs[0][0] == "llmc" and msgs[1][0] == "llmc-torch"
        assert msgs[1][1] == msgs[0][1], chunks
    both("torch", ["range", str(arc), str(out), "--chunks", "1:3"])
    assert out.read_bytes() == bytes(range(16, 48))


def test_range_notes_a_slot_count_it_ignores(both, tmp_path, capsys):
    src = _src(tmp_path)
    arc, out = tmp_path / "a.llmc", tmp_path / "out.bin"
    both("torch", ["compress", str(src), str(arc), "--chunk", "64",
                   "--topk", "0", "--slots", "4"])
    capsys.readouterr()
    errs = []
    for cli, extra in ((jcli, []), (pcli, ["--device", "cpu"])):
        assert cli.main(["range", str(arc), str(out), "--chunks", "0:2",
                         "--slots", "8", *extra]) == 0
        errs.append(capsys.readouterr().err.split(": ", 1)[1])
        assert out.read_bytes() == DATA[:128]
    assert errs[1] == errs[0] and "--slots 8 ignored" in errs[0]


# ----------------------------------------------------------------- stats
_TIMED = re.compile(r"seconds|phase")


@pytest.mark.parametrize("fmt", ["json", "prom", "text"])
def test_stats_agrees_with_jax(both, fmt):
    args = ["stats", "--format", fmt]       # JAX's workload: 2,048 tokens
    jout, pout = both("jax", args), both("torch", args)
    if fmt == "json":
        j, p = json.loads(jout), json.loads(pout)
        for key in ("scheduler", "chunk_bits_per_token", "occupancy",
                    "jobs", "draft_acceptance", "prefix_cache"):
            assert p[key] == j[key], key
        assert p["scheduler"]["chunks_completed"] == 2 * -(-2048 // 64)
        counts = {k: v for k, v in j["metrics"].items()
                  if not _TIMED.search(k)}
        assert {k: v for k, v in p["metrics"].items()
                if not _TIMED.search(k)} == counts
    else:
        def keep(out):
            return [ln for ln in out.splitlines() if not _TIMED.search(ln)]
        assert keep(pout) == keep(jout)
        assert len(keep(pout)) >= 5


# ----------------------------------------------- sidecar, trace, --v3
def _sidecar(path):
    rec = json.loads(pathlib.Path(str(path) + ".diag.json").read_text())
    rec.pop("wall_s", None)
    rec.pop("phases", None)
    for c in rec["chunks"]:
        c["ideal_bits"] = pytest.approx(c["ideal_bits"], rel=1e-12)
    return rec


@pytest.mark.parametrize("flags", [[], ["--v3"], ["--codec", "ac"]],
                         ids=["service", "v3", "ac"])
def test_sidecar_and_trace_agree_with_jax(both, tmp_path, flags):
    src = _src(tmp_path, DATA[:300])
    recs, names, lines = {}, {}, {}
    for which in ("jax", "torch"):
        arc = tmp_path / f"{which}.llmc"
        trace = tmp_path / f"{which}.trace.json"
        out = both(which, ["compress", str(src), str(arc), "--chunk", "32",
                           "--topk", "0", "--slots", "4", *flags,
                           "--sidecar", "--trace", str(trace)])
        lines[which] = [ln.split(" ")[0] for ln in out.splitlines()]
        recs[which] = _sidecar(arc)
        doc = json.loads(trace.read_text())
        names[which] = {e["name"] for e in doc["traceEvents"]
                        if e["ph"] == "X"}
    assert recs["torch"] == recs["jax"]
    assert len(recs["torch"]["chunks"]) == -(-300 // 32)
    assert names["torch"] - names["jax"] <= {"coder.step"}
    assert names["jax"] <= names["torch"] and len(names["jax"]) >= 2
    assert lines["torch"] == lines["jax"]       # timeline, phases, ...
    assert lines["torch"][:3] == ["timeline", "phases", "diagnostics"]


def test_decompress_sidecar_agrees_with_jax(both, tmp_path, capsys):
    src = _src(tmp_path, DATA[:300])
    arc = tmp_path / "a.llmc"
    both("torch", ["compress", str(src), str(arc), "--chunk", "32",
                   "--topk", "0", "--slots", "4"])
    recs = []
    for which in ("jax", "torch"):
        both(which, ["decompress", str(arc), str(tmp_path / "o"),
                     "--sidecar"])
        recs.append(_sidecar(arc))
        assert (tmp_path / "o").read_bytes() == DATA[:300]
    assert recs[1] == recs[0] and recs[0]["kind"] == "decompress"
    # the grouped speculative path writes no sidecar, with JAX's note
    errs = []
    for cli, extra in ((jcli, []), (pcli, ["--device", "cpu"])):
        capsys.readouterr()
        assert cli.main(["decompress", str(arc), str(tmp_path / "o"),
                         "--draft", "2", "--sidecar", *extra]) == 0
        errs.append(capsys.readouterr().err.split(": ", 1)[1])
    assert errs[1] == errs[0] and "skipped" in errs[0]


def test_v3_archive_decodes_on_the_grouped_path(both, tmp_path,
                                               monkeypatch):
    """A v3 archive records no lane count; the grouped path that wrote it
    ran min(slots, chunks) lanes, so it is decoded there, not by the
    service (whose lane count is its slot count)."""
    src = _src(tmp_path)
    arc, back = tmp_path / "a.llmc", tmp_path / "back"
    both("torch", ["compress", str(src), str(arc), "--v3", "--topk", "8"])

    def no_service(*a, **k):
        raise AssertionError("a v3 archive went to the service")
    monkeypatch.setattr(pcli, "_service", no_service)
    both("torch", ["decompress", str(arc), str(back)])
    assert back.read_bytes() == DATA


@pytest.mark.parametrize("flags", [["--route", "auto"],
                                   ["--context-window", "8"]])
def test_v3_refuses_what_jax_refuses(both, tmp_path, flags):
    src = _src(tmp_path, DATA[:100])
    msgs = []
    for cli in (jcli, pcli):
        with pytest.raises(SystemExit) as e:
            cli.main(["compress", str(src), str(tmp_path / "a"), "--v3",
                      *flags])
        msgs.append(str(e.value).split(": ", 1))
    assert msgs[1][1] == msgs[0][1]


# ---------------------------------------------------- model-free decode (F7)
def test_fallback_archive_decodes_without_a_predictor_or_device(
        both, tmp_path, monkeypatch, capsys):
    src = _src(tmp_path)
    arc, back, part = (tmp_path / n for n in ("a.llmc", "back", "part"))
    both("torch", ["compress", str(src), str(arc), "--route", "raw",
                   "--chunk", "64"])

    def refuse(*a, **k):
        raise AssertionError("a model-free decode asked for a model")
    import repro_torch.device
    monkeypatch.setattr(pcli, "_predictor", refuse)
    monkeypatch.setattr(pcli, "_service", refuse)
    monkeypatch.setattr(repro_torch.device, "resolve_device", refuse)
    # the default --device cuda, on a machine that may have no card
    capsys.readouterr()
    for cmd in (["decompress", str(arc), str(back)],
                ["range", str(arc), str(part), "--chunks", "1:4"]):
        assert pcli.main(cmd) == 0
        assert "(model-free, " in capsys.readouterr().out
    assert back.read_bytes() == DATA
    assert part.read_bytes() == DATA[64:256]
    jout = both("jax", ["decompress", str(arc), str(back)])
    assert "(model-free, " in jout
