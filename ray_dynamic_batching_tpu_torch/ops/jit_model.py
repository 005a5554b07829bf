"""Shared static model of the engine's hot-path device programs.

Port of ``ray_dynamic_batching_tpu/ops/jit_model.py``: the single source
of truth for WHICH programs exist on the decode hot path, which engine
state each updates in place, what shape grid each one is specialised
over, and which warmup routine is responsible for capturing it before
serving. ``DecodeEngine.warmup`` cross-checks the capture ledger
(``utils/compile_ledger.py``) against :func:`required_for` — a registered
program its arm needs that warmup did NOT capture is a hard error at
startup, not a capture on a live request's path (and on the card, a key
first seen after warmup raises: ``ops/graphs.py``).

The 18 entries keep the reference's ``name``, ``impl``, ``arm``,
``donated``, ``grid`` and warmed/lazy split; ``attr`` names the port's
engine attribute. ``impl`` names the engine method a program runs, or,
for the draft's long-fill pair, the module-level function of
``engine/decode.py`` bound to the draft (``chunk_impl``, ``commit_row``).
The port changes three things:

- ``donated`` names the state a program updates IN PLACE. A CUDA graph
  bakes in the address of everything it touches, so that state must
  keep its address across calls, as XLA needs a donated buffer.
- ``static`` names the host-static arguments that are part of a
  program's key (beside its input shapes): the reference's static
  ``horizon``, plus what the port decides on the host where the
  reference has a runtime ``lax.cond`` (``any_sampled``,
  ``any_penalty``). The reference's ``donate``/``static`` argnums are
  ``jax.jit`` arguments and have no counterpart here.
- ``eager_reason`` says why the port captures nothing for a program
  (a graph would bake in state that is not at a fixed address). An eager program still records its first
  call of each key in the ledger, so warmup coverage is judged the same
  way for every program.
- A mesh engine's programs all run eagerly (:func:`eager_reason_for`,
  :data:`MESH_EAGER_REASON`): every rank warms its own twin and the
  coverage check holds on each.

Dependency-free (no torch import), like the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

# Engine arms a program serves. An engine instance activates a subset
# (see required_for); warmup is judged per-arm, so the mono engine is
# not required to warm chunk programs it never dispatches.
ARM_ALWAYS = "always"            # every engine configuration
ARM_CHUNKED_PAGED = "chunked_paged"  # chunked_prefill and paged
ARM_CHUNKED_SLAB = "chunked_slab"    # chunked_prefill, slab cache
ARM_MONO = "mono"                # legacy monolithic admission
ARM_SPEC = "spec"                # draft model attached
ARM_SPEC_MONO = "spec_mono"      # draft model AND mono admission

_ROW_CACHE = (
    "the row cache is a fresh cache per long fill or slab train, and the "
    "chunk's start and take row are host ints, so a graph would bake in "
    "one train's row cache and one chunk position"
)
_REUSE = (
    "a row-cache copy: it reads or writes the per-fill row cache (see "
    "long_chunk); warmed by _warmup_reuse when its cache is on, so its one "
    "key is recorded before the steady mark"
)


@dataclass(frozen=True)
class JitProgram:
    """One hot-path device program and its contracts.

    ``attr`` is the engine attribute holding the program (``ops/graphs``
    runner wrapped by ``compile_ledger.instrument``); ``impl`` the method
    it runs. ``donated`` names the state the program updates in place;
    ``static`` the host-static arguments in its key. ``grid`` documents
    the shape axes the program is specialised over; ``warmed_by`` names
    the warmup routine that must invoke ``attr`` (empty iff lazy, with a
    mandatory ``lazy_reason``). ``eager_reason`` is empty iff the port
    captures the program as a CUDA graph.
    """

    name: str
    attr: str
    impl: str
    static: Tuple[str, ...] = ()
    donated: Tuple[str, ...] = ()
    grid: str = ""
    warmed_by: str = ""
    lazy_reason: str = ""
    arm: str = ARM_ALWAYS
    eager_reason: str = ""

    def __post_init__(self) -> None:
        if not self.warmed_by and not self.lazy_reason:
            raise ValueError(
                f"jit program {self.name!r}: not warmed and no "
                "lazy_reason — every hot-path program is either warmed "
                "or explains why a first-hit capture is acceptable"
            )
        if not self.attr and not self.eager_reason:
            raise ValueError(
                f"jit program {self.name!r}: no port attribute and no "
                "eager_reason — a program the port lacks says why"
            )

    @property
    def captured(self) -> bool:
        """The port records this program as a CUDA graph on the card."""
        return not self.eager_reason


HOT_PROGRAMS: Tuple[JitProgram, ...] = (
    JitProgram(
        name="decode_step",
        attr="_decode_fn", impl="_decode_impl",
        static=("horizon", "any_sampled", "any_penalty"),
        donated=("cache", "counts"),
        grid="horizon in {1, ttft_horizon, decode_horizon}",
        warmed_by="_warmup_decode", arm=ARM_ALWAYS,
    ),
    JitProgram(
        name="chunk_prefill",
        attr="_chunk_paged_fn", impl="_chunk_group_paged_impl",
        static=("any_sampled",),
        donated=("pool cache",),
        grid="(bucket x group) via _admit_group_sizes",
        warmed_by="_warmup_impl", arm=ARM_CHUNKED_PAGED,
    ),
    JitProgram(
        name="prefill_group",
        attr="_prefill_fn", impl="_prefill_impl",
        static=("any_sampled",),
        donated=("cache",),
        grid="(bucket x group) via _admit_group_sizes",
        warmed_by="_warmup_prefill_groups", arm=ARM_MONO,
    ),
    JitProgram(
        name="prefill_group_paged",
        attr="_prefill_fn", impl="_prefill_paged_impl",
        static=("any_sampled",),
        donated=("cache",),
        grid="(bucket x group) via _admit_group_sizes",
        warmed_by="_warmup_prefill_groups", arm=ARM_MONO,
    ),
    JitProgram(
        name="spec_verify",
        attr="_spec_fn", impl="_spec_impl",
        donated=("cache", "draft cache"),
        grid="one shape: (num_slots x spec_window)",
        warmed_by="_warmup_decode", arm=ARM_SPEC,
    ),
    JitProgram(
        name="draft_catchup",
        attr="_draft_catchup_fn", impl="_draft_catchup_impl",
        donated=("draft cache",),
        grid="window h in {1, ttft_horizon, decode_horizon}",
        warmed_by="_warmup_decode", arm=ARM_SPEC,
    ),
    JitProgram(
        name="draft_prefill",
        attr="_draft_prefill_fn", impl="_draft_prefill_impl",
        donated=("draft cache",),
        grid="(bucket x group) via _admit_group_sizes",
        warmed_by="_warmup_decode", arm=ARM_SPEC_MONO,
    ),
    JitProgram(
        name="zero_counts",
        attr="_zero_counts_fn", impl="_reset_counts",
        donated=("counts",),
        grid="one shape: (num_slots x vocab)",
        warmed_by="_warmup_decode", arm=ARM_ALWAYS,
    ),
    # --- registered-lazy programs (legacy/slab arms and cold session
    # moves), and the long-fill pair the port runs eagerly.
    JitProgram(
        name="long_chunk",
        attr="_long_chunk_fn", impl="_prefill_chunk_impl",
        donated=("row cache",),
        grid="chunk = largest bucket (one per engine)",
        warmed_by="_warmup_impl", arm=ARM_CHUNKED_SLAB,
        eager_reason=_ROW_CACHE,
    ),
    JitProgram(
        name="long_commit",
        attr="_long_commit_fn", impl="_commit_long_impl",
        donated=("cache",),
        grid="chunk = largest bucket (one per engine)",
        warmed_by="_warmup_impl", arm=ARM_CHUNKED_SLAB,
        eager_reason="reads the per-fill row cache (see long_chunk)",
    ),
    JitProgram(
        name="long_commit_paged",
        attr="_long_commit_fn", impl="_commit_long_paged_impl",
        donated=("cache",),
        grid="chunk = largest bucket",
        lazy_reason="mono-paged engines reach long fills only for "
        "prompts past the largest bucket, which may never arrive; the "
        "persistent compilation cache absorbs the first-hit cost",
        arm=ARM_MONO,
        eager_reason="reads the per-fill row cache (see long_chunk)",
    ),
    JitProgram(
        name="prefix_seed",
        attr="_prefix_seed_fn", impl="_seed_prefix_impl",
        donated=("row cache",),
        grid="one shape per chunk size",
        lazy_reason="prefix-cache CoW seeding rides the long-fill path; "
        "slab engines with no long prompts never dispatch it",
        arm=ARM_MONO, eager_reason=_REUSE,
    ),
    JitProgram(
        name="prefix_extract",
        attr="_prefix_extract_fn", impl="_extract_prefix_impl",
        grid="one shape per (chunk, prefix length bucket)",
        lazy_reason="runs once per prefix PUBLISH (cold, off the decode "
        "turn); publishing is already an amortized slow path",
        arm=ARM_MONO, eager_reason=_REUSE,
    ),
    JitProgram(
        name="paged_seed",
        attr="_paged_seed_fn", impl="_seed_paged_impl",
        donated=("row cache",),
        grid="one shape: (1 x row_cap)",
        lazy_reason="legacy mono-paged session/prefix seeding only; the "
        "chunked-universal arm seeds pages-direct through the chunk "
        "program and never calls this",
        arm=ARM_MONO, eager_reason=_REUSE,
    ),
    JitProgram(
        name="session_seed",
        attr="_session_seed_fn", impl="_seed_session_impl",
        donated=("row cache",),
        grid="one shape: (1 x max_len)",
        lazy_reason="slab session continuation only — sessions may "
        "never be enabled; first turn-2 on a restart pays it once",
        arm=ARM_MONO, eager_reason=_REUSE,
    ),
    JitProgram(
        name="session_extract",
        attr="_session_extract_fn", impl="_extract_row_impl",
        grid="one shape: (1 x max_len)",
        lazy_reason="runs once per session FINISH (cold, off the "
        "decode turn) to pin the finished row",
        arm=ARM_MONO, eager_reason=_REUSE,
    ),
    JitProgram(
        name="draft_long_chunk",
        attr="_draft_long_chunk_fn", impl="chunk_impl",
        donated=("draft row cache",),
        grid="chunk = largest bucket",
        lazy_reason="spec engines see long prompts rarely; the draft's "
        "chunk program compiles once at the first long admission and "
        "the chunk-stall bound already prices that turn",
        arm=ARM_SPEC, eager_reason=_ROW_CACHE,
    ),
    JitProgram(
        name="draft_long_commit",
        attr="_draft_long_commit_fn", impl="commit_row",
        donated=("draft cache",),
        grid="chunk = largest bucket",
        lazy_reason="paired with draft_long_chunk — same cold path",
        arm=ARM_SPEC,
        eager_reason="reads the per-fill draft row cache (see long_chunk)",
    ),
)

_BY_NAME: Dict[str, JitProgram] = {p.name: p for p in HOT_PROGRAMS}

_ASR_STREAM = (
    "each stream makes a fresh ASRCache sized by its prefix's text bucket "
    "and its own cross K/V, so a graph would bake in one stream's buffers"
)

#: ``models/asr.py::StreamingASR``'s programs, beside the decode engine's
#: (not part of its arms or its warmup): the reference jits them per
#: (chunk bucket, text bucket); the port runs them eagerly, for the
#: reason each records.
ASR_PROGRAMS: Tuple[JitProgram, ...] = tuple(
    JitProgram(name=f"asr_{impl}", attr="", impl=impl,
               grid="chunk bucket x text bucket",
               lazy_reason="a stream's first chunk of each bucket runs it "
                           "first; eager programs capture nothing",
               eager_reason=_ASR_STREAM)
    for impl in ("encode", "prefill", "decode_step"))


#: Why every program of a tensor-parallel (mesh) engine runs eagerly, by
#: the mesh's backend.
MESH_EAGER_REASON = {
    "gloo": "gloo's collectives run on the host (CUDA tensors are staged "
            "through host memory), and a CUDA graph cannot capture them",
    "nccl": "capturing a TP program's NCCL collectives in a CUDA graph "
            "waits for a machine with two devices, where it can be "
            "verified",
}


def eager_reason_for(name: str, mesh_backend=None) -> str:
    """Why the port runs program ``name`` eagerly on an engine whose
    mesh has ``mesh_backend`` (None: no mesh); empty if it is captured."""
    own = _BY_NAME[name].eager_reason
    if own or mesh_backend is None:
        return own
    return MESH_EAGER_REASON[mesh_backend]


def program(name: str) -> JitProgram:
    return _BY_NAME[name]


def program_names() -> Tuple[str, ...]:
    return tuple(_BY_NAME)


def warmed_programs() -> Tuple[JitProgram, ...]:
    return tuple(p for p in HOT_PROGRAMS if p.warmed_by)


def lazy_programs() -> Tuple[JitProgram, ...]:
    return tuple(p for p in HOT_PROGRAMS if not p.warmed_by)


def required_for(chunked_prefill: bool, paged: bool,
                 has_draft: bool) -> Tuple[JitProgram, ...]:
    """Warmed programs an engine configuration MUST run during warmup —
    the runtime coverage check's ground truth. Mirrors the dispatch in
    ``DecodeEngine._warmup_impl``: chunked+paged warms the chunk program,
    slab-chunked the long chunk/commit pair, mono the (bucket x group)
    prefill grid; spec engines add verify + catch-up, and only MONO spec
    engines add the draft group-prefill grid."""
    arms = {ARM_ALWAYS}
    if chunked_prefill and paged:
        arms.add(ARM_CHUNKED_PAGED)
    elif chunked_prefill:
        arms.add(ARM_CHUNKED_SLAB)
    else:
        arms.add(ARM_MONO)
    if has_draft:
        arms.add(ARM_SPEC)
        if not chunked_prefill:
            arms.add(ARM_SPEC_MONO)
    out = []
    for p in warmed_programs():
        if p.arm not in arms:
            continue
        # The prefill_group pair is impl-dispatched on paged-ness; only
        # one of the two runs on a given engine.
        if p.name == "prefill_group" and paged:
            continue
        if p.name == "prefill_group_paged" and not paged:
            continue
        # Slab-arm long programs: _commit_long_impl serves slab engines,
        # _commit_long_paged_impl is registered lazy for mono-paged.
        if p.name == "long_commit" and paged:
            continue
        out.append(p)
    return tuple(out)
