"""Batch-profile tables — the scheduler's ground truth.

Own copy of ``ray_dynamic_batching_tpu/profiles/table.py``, whole (it is
pure host code and imports nothing of the package): a CSV or JSON table
written by either package reads the same in the other. The column
semantics below are the reference's; the port's H100 tables fill
``hbm_bytes`` and ``compile_ms`` as ``profiles/decode_profiler.py`` says.

Re-creates the contract of the reference's committed profiler outputs
(``293-project/profiling/*_summary.csv``, loaded by the scheduler at
``293-project/src/scheduler.py:1019-1041``): per-(batch, seq) rows of measured
latency / throughput / memory that drive SLO-aware batch selection.

TPU-first differences from the reference CSVs:
- rows exist only at *bucket* sizes (each bucket is one compiled XLA program;
  arbitrary batch sizes 1..512 are not "free" like eager CUDA — SURVEY.md §7
  hard part (a)), and lookups round **up** to the nearest profiled bucket;
- each row carries ``hbm_bytes`` (total program footprint incl. weights) and
  ``compile_ms`` so the planner can budget HBM and amortize compiles;
- a ``seq_len`` column generalizes the table to shape-bucketed LLM prefill
  (0 = fixed-shape vision input);
- a ``mesh`` column generalizes the table to mesh-sliced placements
  (ROADMAP item 2): ``"1x4"`` rows describe the model compiled over a
  4-chip TP slice — ``latency_ms`` is the whole-slice step latency,
  ``hbm_bytes`` the PER-CHIP footprint (what each chip's budget must
  absorb: weights/tp + its activation shard), and throughput the whole
  slice's. Single-chip rows are ``mesh="1x1"``, the loader default, so
  every committed table reads unchanged and every lookup that doesn't
  ask for a mesh keeps seeing exactly the rows it always did;
- a ``spec`` column generalizes the table to speculative decoding:
  ``spec="on"`` rows describe one VERIFY ROUND (draft +
  window verify), converted to an effective per-step cost by
  :func:`expected_tokens_per_round` at the session's acceptance rate.
  ``"off"`` is the loader default — pre-spec tables read unchanged.
"""

from __future__ import annotations

import csv
import io
import json
import math
from dataclasses import asdict, dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class ProfileRow:
    batch_size: int
    seq_len: int                 # 0 for fixed-shape models
    latency_ms: float            # mean step latency at this bucket
    latency_std_ms: float
    hbm_bytes: int               # total device footprint (weights+activations)
    compile_ms: float            # one-time XLA compile cost for this bucket
    throughput_sps: float = 0.0  # batch_size / latency
    mesh: str = "1x1"            # mesh shape this row was measured at
    # Speculative-decoding axis: "off" rows are plain decode
    # steps; "on" rows were measured with a draft model attached, and
    # their latency_ms is the cost of ONE VERIFY ROUND (draft k+1 steps
    # + the target's window verify). The effective per-step cost at
    # acceptance rate a is latency_ms / expected_tokens_per_round(a, k)
    # — the conversion every consumer (packer, sim engine) applies, so
    # a spec row never pretends a round is a step. Pre-spec tables load
    # as "off" and default lookups are byte-identical.
    spec: str = "off"

    def with_throughput(self) -> "ProfileRow":
        tput = self.batch_size / (self.latency_ms / 1000.0) if self.latency_ms else 0.0
        return ProfileRow(
            self.batch_size,
            self.seq_len,
            self.latency_ms,
            self.latency_std_ms,
            self.hbm_bytes,
            self.compile_ms,
            tput,
            self.mesh,
            self.spec,
        )


def mesh_chips(mesh: str) -> int:
    """Chip count of a mesh-shape string (``"1x4"`` -> 4). The shared
    parse — the packer's chip-set sizing, the replan matcher's width
    compatibility, and the sim's slice accounting all go through here so
    a malformed shape fails identically everywhere."""
    try:
        dims = [int(d) for d in str(mesh).lower().split("x")]
    except ValueError:
        dims = []
    if not dims or any(d <= 0 for d in dims):
        raise ValueError(f"malformed mesh shape {mesh!r} (want e.g. '1x4')")
    n = 1
    for d in dims:
        n *= d
    return n


CSV_FIELDS = [
    "batch_size",
    "seq_len",
    "latency_ms",
    "latency_std_ms",
    "hbm_bytes",
    "compile_ms",
    "throughput_sps",
    "mesh",
    "spec",
]


def expected_tokens_per_round(acceptance: float, spec_tokens: int) -> float:
    """Expected emitted tokens of one speculative verify round when each
    draft token is accepted independently with probability
    ``acceptance`` (the Leviathan et al. expectation): a round emits the
    longest accepted draft prefix plus the target's own correction —
    between 1 and k+1 tokens — so

        E[n] = (1 - a^(k+1)) / (1 - a)      (a < 1; k+1 at a == 1).

    THE shared conversion between a spec profile row's per-ROUND latency
    and an effective per-step cost: the packer, the sim engine, and the
    soak grade all divide by this — one formula, so the planner's belief
    and the simulated timeline can never disagree about what an
    acceptance rate is worth. Clamped to [1, k+1]; a <= 0 (total
    collapse) is exactly 1 token per round."""
    k = max(0, int(spec_tokens))
    a = float(acceptance)
    if a <= 0.0:
        return 1.0
    if a >= 1.0:
        return float(k + 1)
    return (1.0 - a ** (k + 1)) / (1.0 - a)


class BatchProfile:
    """All profiled buckets for one model (one seq bucket group per seq_len)."""

    def __init__(self, model_name: str, rows: Iterable[ProfileRow] = ()):
        self.model_name = model_name
        self.rows: List[ProfileRow] = sorted(
            (r.with_throughput() for r in rows),
            key=lambda r: (r.seq_len, r.batch_size, r.mesh, r.spec),
        )

    # --- construction -----------------------------------------------------
    def add(self, row: ProfileRow) -> None:
        self.rows.append(row.with_throughput())
        self.rows.sort(
            key=lambda r: (r.seq_len, r.batch_size, r.mesh, r.spec)
        )

    # --- lookups (always round batch UP to a profiled bucket) -------------
    def _seq_rows(self, seq_len: int = 0, mesh: str = "1x1",
                  spec: str = "off") -> List[ProfileRow]:
        pool = [r for r in self.rows if r.mesh == mesh and r.spec == spec]
        if not pool and spec != "off":
            # A spec session on a table with no spec rows: fall back to
            # the plain rows (the caller's speedup conversion then sees
            # spec pricing as unavailable — never a KeyError mid-plan).
            pool = [r for r in self.rows if r.mesh == mesh
                    and r.spec == "off"]
        rows = [r for r in pool if r.seq_len == seq_len]
        if not rows and pool:
            # fall back to nearest profiled seq bucket >= requested
            seqs = sorted({r.seq_len for r in pool})
            chosen = next((s for s in seqs if s >= seq_len), seqs[-1])
            rows = [r for r in pool if r.seq_len == chosen]
        return rows

    def meshes(self) -> List[str]:
        """Mesh shapes this table has rows for, smallest slice first —
        the degrade ladder ``scheduler/replan.degrade_sessions`` walks
        when a model's preferred slice width no longer exists."""
        return sorted({r.mesh for r in self.rows}, key=mesh_chips)

    def buckets(self, seq_len: int = 0, mesh: str = "1x1") -> List[int]:
        return [r.batch_size for r in self._seq_rows(seq_len, mesh)]

    def specs(self) -> List[str]:
        """Spec arms this table has rows for ("off" first)."""
        return sorted({r.spec for r in self.rows})

    def bucket_for(self, batch_size: int, seq_len: int = 0,
                   mesh: str = "1x1", spec: str = "off"
                   ) -> Optional[ProfileRow]:
        """Smallest profiled bucket >= batch_size (None if beyond the table)."""
        for r in self._seq_rows(seq_len, mesh, spec):
            if r.batch_size >= batch_size:
                return r
        return None

    def row_for(self, batch_size: int, seq_len: int = 0,
                mesh: str = "1x1", spec: str = "off"
                ) -> Optional[ProfileRow]:
        for r in self._seq_rows(seq_len, mesh, spec):
            if r.batch_size == batch_size:
                return r
        return None

    def latency_ms(self, batch_size: int, seq_len: int = 0,
                   mesh: str = "1x1") -> float:
        row = self.bucket_for(batch_size, seq_len, mesh)
        if row is None:
            raise KeyError(
                f"{self.model_name}: no profiled bucket >= batch {batch_size}"
            )
        return row.latency_ms

    def largest_within_latency(
        self, max_latency_ms: float, seq_len: int = 0,
        hbm_budget_bytes: Optional[int] = None, mesh: str = "1x1",
    ) -> Optional[ProfileRow]:
        """Largest bucket whose latency (and HBM) fit — the Nexus 'saturate'
        selection rule (ref nexus.py:154-165), against measured buckets."""
        best = None
        for r in self._seq_rows(seq_len, mesh):
            if r.latency_ms <= max_latency_ms and (
                hbm_budget_bytes is None or r.hbm_bytes <= hbm_budget_bytes
            ):
                best = r
        return best

    def max_throughput(self, seq_len: int = 0, mesh: str = "1x1") -> float:
        rows = self._seq_rows(seq_len, mesh)
        return max((r.throughput_sps for r in rows), default=0.0)

    def weights_hbm_bytes(self, mesh: Optional[str] = None,
                          spec: Optional[str] = None) -> int:
        """Lower bound on resident footprint: min over rows (≈ weights).

        ``mesh`` restricts to rows measured at that shape — necessary
        on mixed-mesh tables, where per-chip footprints differ by slice
        width (a 1x2 row carries twice the weight shard of a 1x4 row)
        and the unrestricted min would always answer with the WIDEST
        mesh's shard, underpricing uploads to narrower shapes. ``spec``
        restricts analogously on mixed-arm tables: a spec row's
        footprint includes the draft model's weights, which the plain
        rows' min would shave off. Falls back progressively (drop the
        spec restriction, then the mesh one) when the table has no rows
        at the requested combination — the pre-mesh behavior, and the
        safe lower bound when a shape is missing."""
        if mesh is not None:
            if spec is not None:
                at_both = min(
                    (r.hbm_bytes for r in self.rows
                     if r.mesh == mesh and r.spec == spec),
                    default=0,
                )
                if at_both > 0:
                    return at_both
            at_mesh = min(
                (r.hbm_bytes for r in self.rows if r.mesh == mesh),
                default=0,
            )
            if at_mesh > 0:
                return at_mesh
        return min((r.hbm_bytes for r in self.rows), default=0)

    # --- persistence (the CSV/JSON contract) ------------------------------
    def to_csv(self, path: Optional[str] = None) -> str:
        buf = io.StringIO()
        w = csv.DictWriter(buf, fieldnames=CSV_FIELDS)
        w.writeheader()
        for r in self.rows:
            w.writerow(asdict(r))
        text = buf.getvalue()
        if path:
            with open(path, "w") as f:
                f.write(text)
        return text

    @classmethod
    def from_csv(cls, model_name: str, text_or_path: str) -> "BatchProfile":
        if "\n" not in text_or_path:
            with open(text_or_path) as f:
                text = f.read()
        else:
            text = text_or_path
        rows = []
        for rec in csv.DictReader(io.StringIO(text)):
            rows.append(
                ProfileRow(
                    batch_size=int(rec["batch_size"]),
                    seq_len=int(rec.get("seq_len", 0) or 0),
                    latency_ms=float(rec["latency_ms"]),
                    latency_std_ms=float(rec.get("latency_std_ms", 0) or 0),
                    hbm_bytes=int(float(rec.get("hbm_bytes", 0) or 0)),
                    compile_ms=float(rec.get("compile_ms", 0) or 0),
                    # Pre-mesh tables have no column: single-chip rows.
                    mesh=str(rec.get("mesh") or "1x1"),
                    # Pre-spec tables have no column: plain decode rows.
                    spec=str(rec.get("spec") or "off"),
                )
            )
        return cls(model_name, rows)

    def to_json(self) -> str:
        return json.dumps(
            {"model": self.model_name, "rows": [asdict(r) for r in self.rows]},
            indent=2,
        )

    @classmethod
    def from_json(cls, text: str) -> "BatchProfile":
        obj = json.loads(text)
        return cls(obj["model"], [ProfileRow(**r) for r in obj["rows"]])

    def report(self) -> str:
        """Human-readable report (analogue of the reference's report.txt)."""
        lines = [f"# Batch profile: {self.model_name}", ""]
        best_t = max(self.rows, key=lambda r: r.throughput_sps, default=None)
        best_l = min(self.rows, key=lambda r: r.latency_ms, default=None)
        if best_t:
            lines.append(
                f"best throughput: {best_t.throughput_sps:.1f} samples/s "
                f"@ batch {best_t.batch_size} seq {best_t.seq_len} "
                f"({best_t.latency_ms:.2f} ms)"
            )
        if best_l:
            lines.append(
                f"best latency: {best_l.latency_ms:.2f} ms @ batch "
                f"{best_l.batch_size} seq {best_l.seq_len}"
            )
        lines.append("")
        lines.append(
            f"{'batch':>6} {'seq':>6} {'lat_ms':>10} {'std':>8} "
            f"{'tput':>10} {'hbm_mb':>9} {'compile_ms':>10}"
        )
        for r in self.rows:
            lines.append(
                f"{r.batch_size:>6} {r.seq_len:>6} {r.latency_ms:>10.2f} "
                f"{r.latency_std_ms:>8.2f} {r.throughput_sps:>10.1f} "
                f"{r.hbm_bytes / 1e6:>9.1f} {r.compile_ms:>10.0f}"
            )
        return "\n".join(lines) + "\n"


def bucket_up(value: int, buckets: Sequence[int]) -> Optional[int]:
    """Smallest bucket >= value; None if value exceeds every bucket."""
    for b in sorted(buckets):
        if b >= value:
            return b
    return None


def default_batch_buckets(max_batch: int, min_batch: int = 1) -> List[int]:
    """Power-of-two buckets — one XLA program each, bounded jit-cache size."""
    out = []
    b = min_batch
    while b <= max_batch:
        out.append(b)
        b *= 2
    return out


def default_seq_buckets(max_seq: int, min_seq: int = 32) -> List[int]:
    out = []
    s = min_seq
    while s <= max_seq:
        out.append(s)
        s *= 2
    return out


class ProfileStore:
    """Named profile collection the scheduler reads (ref: profile CSVs dir)."""

    def __init__(self) -> None:
        self._profiles: Dict[str, BatchProfile] = {}

    def put(self, profile: BatchProfile) -> None:
        self._profiles[profile.model_name] = profile

    def get(self, model_name: str) -> BatchProfile:
        if model_name not in self._profiles:
            raise KeyError(f"no profile for model {model_name!r}")
        return self._profiles[model_name]

    def __contains__(self, model_name: str) -> bool:
        return model_name in self._profiles

    def models(self) -> List[str]:
        return sorted(self._profiles)

    def load_dir(self, path: str) -> None:
        import os

        for fn in os.listdir(path):
            if fn.endswith(".csv"):
                name = fn[: -len(".csv")]
                self.put(BatchProfile.from_csv(name, os.path.join(path, fn)))
