"""Per-chunk / per-job compression diagnostics.

The paper's ratio claim is a measurement claim — compression ratio *is*
realized cross-entropy under the generating model — so the system
records, per chunk, the quantities the adaptive codec router (ROADMAP)
will route on:

* ``coded_bits`` — the quantized code length actually paid by the
  entropy coder (``precision - log2(freq)`` summed over coded symbols,
  escapes charged their uniform bits). ``coded_bits / n_tokens`` is the
  chunk's realized bits/token under the *quantized* model.
* ``ideal_bits`` — the un-quantized model cross-entropy (compress side
  only; the decoder never needs it). ``coded - ideal`` is the
  quantization + top-k overhead.
* escape count, speculative-decode round/acceptance/rollback counts,
  codec id — the model-fit and wall-clock signals.

``JobDiagnostics`` aggregates a job's chunks and serializes to a JSON
**sidecar** (``<container>.diag.json`` by convention): diagnostics ride
NEXT TO the container, never inside it — telemetry must not change
output bytes (the byte-identity property tests in tests/test_obs.py pin
this).
"""
from __future__ import annotations

import json
import pathlib
from dataclasses import asdict, dataclass, field
from typing import Optional

SIDECAR_SUFFIX = ".diag.json"


@dataclass
class ChunkDiagnostics:
    """One chunk's compression telemetry (either direction)."""
    chunk_index: int
    n_tokens: int
    stream_bytes: int
    coded_bits: float = 0.0      # quantized code length (excl. framing)
    ideal_bits: float = 0.0      # model cross-entropy, compress side only
    n_escapes: int = 0
    draft_rounds: int = 0        # speculative decode only
    draft_accepted: int = 0      # drafted tokens accepted (bonus yield)
    rollbacks: int = 0
    codec: str = ""              # per-chunk codec name (v5 routing)
    context: str = ""            # context recipe, e.g. "carry(64)" (v6)

    @property
    def bits_per_token(self) -> float:
        """Realized payload bits/token (stream bytes are ground truth)."""
        return 8.0 * self.stream_bytes / self.n_tokens \
            if self.n_tokens else 0.0

    @property
    def cross_entropy(self) -> float:
        """Model cross-entropy in bits/token (0 when not recorded)."""
        return self.ideal_bits / self.n_tokens if self.n_tokens else 0.0

    @property
    def escape_rate(self) -> float:
        return self.n_escapes / self.n_tokens if self.n_tokens else 0.0

    def to_dict(self) -> dict:
        d = asdict(self)
        if not d["context"]:
            # context is a v6-only concept; keep v2-v5 sidecars
            # byte-identical to their pre-v6 form
            del d["context"]
        d["bits_per_token"] = round(self.bits_per_token, 4)
        d["cross_entropy"] = round(self.cross_entropy, 4)
        d["escape_rate"] = round(self.escape_rate, 5)
        return d


@dataclass
class JobDiagnostics:
    """A job's aggregated telemetry + its per-chunk records."""
    job_id: int = 0
    kind: str = ""
    codec: str = ""
    n_tokens: int = 0
    container_bytes: int = 0
    chunks: list = field(default_factory=list)   # [ChunkDiagnostics]
    wall_s: float = 0.0          # submit→done wall (0 when not recorded)
    phases: Optional[dict] = None   # PhaseReport.to_dict() (DESIGN.md §13)

    @property
    def payload_bytes(self) -> int:
        return sum(c.stream_bytes for c in self.chunks)

    @property
    def bits_per_token(self) -> float:
        n = sum(c.n_tokens for c in self.chunks)
        return 8.0 * self.payload_bytes / n if n else 0.0

    @property
    def cross_entropy(self) -> float:
        n = sum(c.n_tokens for c in self.chunks)
        return sum(c.ideal_bits for c in self.chunks) / n if n else 0.0

    @property
    def escape_rate(self) -> float:
        n = sum(c.n_tokens for c in self.chunks)
        return sum(c.n_escapes for c in self.chunks) / n if n else 0.0

    @property
    def draft_acceptance(self) -> Optional[float]:
        """Accepted drafted tokens per offered draft slot, or None when
        the job never ran the speculative path."""
        rounds = sum(c.draft_rounds for c in self.chunks)
        if not rounds:
            return None
        return sum(c.draft_accepted for c in self.chunks) / rounds

    def to_dict(self) -> dict:
        d = {
            "job_id": self.job_id, "kind": self.kind, "codec": self.codec,
            "n_tokens": self.n_tokens,
            "container_bytes": self.container_bytes,
            "payload_bytes": self.payload_bytes,
            "bits_per_token": round(self.bits_per_token, 4),
            "cross_entropy": round(self.cross_entropy, 4),
            "escape_rate": round(self.escape_rate, 5),
            "chunks": [c.to_dict() for c in self.chunks],
        }
        acc = self.draft_acceptance
        if acc is not None:
            d["draft_acceptance"] = round(acc, 4)
        # attribution fields only when recorded — pre-§13 sidecars stay
        # byte-identical
        if self.wall_s:
            d["wall_s"] = round(self.wall_s, 6)
        if self.phases is not None:
            d["phases"] = self.phases
        return d

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent)


def sidecar_path(container_path) -> pathlib.Path:
    """Conventional sidecar location for a container file."""
    p = pathlib.Path(container_path)
    return p.with_name(p.name + SIDECAR_SUFFIX)


def write_sidecar(container_path, diag: JobDiagnostics) -> pathlib.Path:
    """Write the job's diagnostics next to its container; returns the
    sidecar path."""
    p = sidecar_path(container_path)
    p.write_text(diag.to_json())
    return p


def read_sidecar(container_path) -> dict:
    return json.loads(sidecar_path(container_path).read_text())
