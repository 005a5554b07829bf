"""The port's hot-program registry (``ops/jit_model.py``) and the engine's
warmup coverage, against the JAX package's (CPU, f32).

- The registry equals the reference's entry by entry (name, impl, arm,
  donated, grid, warmed_by, lazy_reason), and ``required_for`` agrees on
  all 8 (chunked_prefill, paged, has_draft) combinations.
- On ``llama_tiny`` (JAX params bridged by ``params_from_flax``; the
  canonical engine of ``tools/check_compiles.py``: 4 slots, ``max_len``
  96, buckets [8, 16], horizon 4) on each of the five arms — slab, paged
  (chunked), int8 slab, int8 paged, slab trains: warmup's episodes cover
  ``required_for``; the names warmed equal the JAX engine's ledger, plus,
  on the monolithic arms, the long fill's chunk and commit, which the
  port warms because a prompt past the largest bucket fits (the JAX
  engine leaves them to the first long prompt: a steady-state compile
  there, which this test reads off its ledger); a served segment (the
  canonical seed-17 mix, long prompts among them, one penalised and one
  sampled request) adds zero steady episodes, and its greedy tokens are
  exactly the JAX engine's (f32); a warmup stripped of one required
  program raises the coverage error; every ``donated`` buffer keeps its
  ``data_ptr()`` across each call of its program, and the engine's state
  keeps its addresses from construction to the end of the segment.
"""

import collections

import jax
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ray_dynamic_batching_tpu.engine.decode import DecodeEngine as JEngine
from ray_dynamic_batching_tpu.engine.queue import RequestQueue as JQueue
from ray_dynamic_batching_tpu.engine.request import Request as JRequest
from ray_dynamic_batching_tpu.models import causal_lm as j_lm
from ray_dynamic_batching_tpu.ops import jit_model as j_reg
from ray_dynamic_batching_tpu.utils import compile_ledger as j_ledger
from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
from ray_dynamic_batching_tpu_torch.engine.request import Request
from ray_dynamic_batching_tpu_torch.models import causal_lm as t_lm
from ray_dynamic_batching_tpu_torch.models.convert import params_from_flax
from ray_dynamic_batching_tpu_torch.ops import jit_model as t_reg
from ray_dynamic_batching_tpu_torch.utils.compile_ledger import (
    PHASE_WARMUP,
    get_ledger,
)

torch.set_num_threads(2)

FIELDS = ("name", "impl", "arm", "donated", "grid", "warmed_by",
          "lazy_reason")
UNATTRIBUTED = "__unattributed__"


def test_registry_equals_the_reference_entry_by_entry():
    assert t_reg.program_names() == j_reg.program_names()
    for t, j in zip(t_reg.HOT_PROGRAMS, j_reg.HOT_PROGRAMS):
        assert ({f: getattr(t, f) for f in FIELDS}
                == {f: getattr(j, f) for f in FIELDS})
    assert ([p.name for p in t_reg.warmed_programs()]
            == [p.name for p in j_reg.warmed_programs()])
    assert ([p.name for p in t_reg.lazy_programs()]
            == [p.name for p in j_reg.lazy_programs()])


@pytest.mark.parametrize("has_draft", [False, True])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("chunked", [False, True])
def test_required_for_agrees_with_the_reference(chunked, paged, has_draft):
    assert ([p.name for p in t_reg.required_for(chunked, paged, has_draft)]
            == [p.name for p in j_reg.required_for(chunked, paged,
                                                   has_draft)])


def test_port_entries_name_real_engine_programs():
    """Every entry names the port's engine attribute holding it and the
    impl it runs — an engine method or, for the draft's long-fill pair, a
    function of ``engine/decode.py`` that the engine binds to the draft —
    whose parameters include its static names; a program the port runs
    eagerly says why. The captured set is the eight programs whose state
    is at fixed addresses, the three speculative ones among them, and a
    spec engine holds every entry's attribute."""
    import inspect

    from ray_dynamic_batching_tpu_torch.engine import decode as t_decode

    spec_arms = (t_reg.ARM_SPEC, t_reg.ARM_SPEC_MONO)
    for p in t_reg.HOT_PROGRAMS:
        assert p.attr, p.name
        impl = getattr(DecodeEngine, p.impl, None) or getattr(t_decode,
                                                              p.impl)
        params = inspect.signature(impl).parameters
        assert set(p.static) <= set(params), p.name
        assert p.captured or p.eager_reason, p.name
        assert not p.eager_reason.startswith("not ported"), p.name
    assert {p.name for p in t_reg.HOT_PROGRAMS if p.captured} == {
        "decode_step", "chunk_prefill", "prefill_group",
        "prefill_group_paged", "zero_counts", "spec_verify",
        "draft_catchup", "draft_prefill"}
    assert {p.name for p in t_reg.HOT_PROGRAMS if p.arm in spec_arms} == {
        "spec_verify", "draft_catchup", "draft_prefill", "draft_long_chunk",
        "draft_long_commit"}
    tm = t_lm.CausalLM(t_lm.TINY_LM, name="llama_tiny", dtype=torch.float32,
                       device="cpu", seed=0)
    for knobs in (dict(chunked_prefill=False), PAGED):
        engine = DecodeEngine(tm, RequestQueue("t", max_len=16),
                              device="cpu", draft_model=tm,
                              **{**BASE, **knobs})
        for p in t_reg.HOT_PROGRAMS:
            # The slab/paged pairs share one attribute.
            names = {f"ledger[{q.name}]" for q in t_reg.HOT_PROGRAMS
                     if q.attr == p.attr}
            assert getattr(engine, p.attr).__name__ in names, p.name
    with pytest.raises(ValueError, match="eager_reason"):
        t_reg.JitProgram(name="x", attr="", impl="y", warmed_by="z")


# --- the engine on llama_tiny -----------------------------------------------
@pytest.fixture(scope="module")
def models():
    out = {}
    for kv, j_kv, t_kv in (("f32", None, None),
                           ("int8", jnp.int8, torch.int8)):
        jm = j_lm.CausalLM(j_lm.TINY_LM, name="llama_tiny",
                           dtype=jnp.float32, kv_dtype=j_kv)
        params = jm.init(jax.random.PRNGKey(0))
        tm = t_lm.CausalLM(t_lm.TINY_LM, name="llama_tiny",
                           dtype=torch.float32, device="cpu", seed=None,
                           kv_dtype=t_kv)
        tm.module.load_state_dict(params_from_flax(
            jax.tree_util.tree_map(np.asarray, params), tm.cfg))
        out[kv] = (jm, params, tm)
    return out


BASE = dict(num_slots=4, max_len=96, prompt_buckets=[8, 16],
            eos_token_id=None, default_max_new_tokens=8, decode_horizon=4)
PAGED = dict(paged=True, page_size=128, chunked_prefill=True)
ARMS = {
    "slab": ("f32", dict(chunked_prefill=False)),
    "paged": ("f32", PAGED),
    "int8": ("int8", dict(chunked_prefill=False)),
    "int8_paged": ("int8", PAGED),
    "slab_chunked": ("f32", dict(chunked_prefill=True)),
}


def _segment():
    """check_compiles.py's seed-17 mix (every third prompt 40-69 tokens:
    past the largest bucket), the fifth request with repetition
    penalties, then one sampled request."""
    rng = np.random.default_rng(17)
    out = []
    for i in range(10):
        plen = (int(rng.integers(3, 14)) if i % 3
                else int(rng.integers(40, 70)))
        out.append({"tokens": rng.integers(1, 500, plen).tolist(),
                    "max_new_tokens": 6})
    out[4].update(presence_penalty=0.5, frequency_penalty=0.3)
    out.append({"tokens": rng.integers(1, 500, 9).tolist(),
                "max_new_tokens": 6, "temperature": 0.8, "top_k": 20,
                "seed": 3})
    return out


def _serve(engine, queue, make_request):
    reqs = [make_request(p) for p in _segment()]
    for r in reqs:
        queue.add_request(r)
    engine.run_until_idle(timeout_s=300)
    return [r.future.result(timeout=5).tokens for r in reqs]


def _port_engine(models, arm, draft: bool = False):
    """The arm's engine; ``draft``: speculative, the target its own draft
    (three proposals a round)."""
    kv, knobs = ARMS[arm]
    queue = RequestQueue("t", max_len=256)
    extra = dict(draft_model=models[kv][2], spec_tokens=3) if draft else {}
    return DecodeEngine(models[kv][2], queue, device="cpu",
                        **{**BASE, **knobs, **extra}), queue


def _long_fill(engine) -> set:
    """The long-fill pair a monolithic engine warms beyond the
    reference's grid (a prompt past the largest bucket fits)."""
    if engine.chunked_prefill:
        return set()
    return {"long_chunk",
            "long_commit_paged" if engine.paged else "long_commit"}


@pytest.mark.parametrize("arm", list(ARMS))
def test_warmup_covers_serving_like_the_reference(models, arm):
    kv, knobs = ARMS[arm]
    jm, params, _tm = models[kv]
    jl = j_ledger.get_ledger()
    jl.reset()
    try:
        jq = JQueue("j", max_len=256)
        je = JEngine(jm, params, jq, **{**BASE, **knobs})
        je.warmup()
        j_warm = set(jl.counts(phase=j_ledger.PHASE_WARMUP)) - {UNATTRIBUTED}
        j_tokens = _serve(je, jq, lambda p: JRequest(model="j", payload=p,
                                                     slo_ms=6e4))
        j_steady = {v["fn"] for v in jl.violations()} - {UNATTRIBUTED}
    finally:
        jl.reset()

    tl = get_ledger()
    tl.reset()
    try:
        engine, queue = _port_engine(models, arm)
        engine.warmup()
        t_warm = set(tl.counts(phase=PHASE_WARMUP))
        t_tokens = _serve(engine, queue, lambda p: Request(
            model="t", payload=p, slo_ms=6e4))
        violations = tl.violations()
    finally:
        tl.reset()

    required = {p.name for p in t_reg.required_for(
        engine.chunked_prefill, engine.paged, False)}
    assert required <= t_warm
    assert t_warm == j_warm | _long_fill(engine)
    assert violations == []
    assert j_steady == _long_fill(engine)
    assert t_tokens[:10] == j_tokens[:10]     # the greedy requests
    assert all(len(t) == 6 for t in t_tokens)
    if engine.paged:
        engine._allocator.check()
        assert engine._allocator.free_pages == engine.num_pages


def _required_cases():
    for arm, (_kv, knobs) in ARMS.items():
        chunked = knobs["chunked_prefill"]
        paged = knobs.get("paged", False)
        for p in t_reg.required_for(chunked, paged, False):
            yield arm, p.name


@pytest.mark.parametrize("arm,program", list(_required_cases()))
def test_warmup_stripped_of_a_program_raises(models, arm, program):
    """The program's attribute runs its bare impl (no ledger, no
    capture): warmup still dispatches it, records no episode for it, and
    the coverage check names it."""
    engine, _queue = _port_engine(models, arm)
    spec = t_reg.program(program)
    setattr(engine, spec.attr, getattr(engine, spec.impl))
    with pytest.raises(RuntimeError, match=f"warmup coverage gap.*{program}"):
        engine.warmup()


def _tensors(obj) -> tuple:
    return tuple((name, t.data_ptr()) for name, t in sorted(vars(obj).items())
                 if isinstance(t, torch.Tensor))


def _held_addresses(engine, queue) -> set:
    """Warm ``engine`` and serve the segment with every program wrapped:
    each ``donated`` buffer keeps its ``data_ptr()`` across each call of
    its program, and the engine's state (the cache, the counts and, with
    a draft, the draft's cache) keeps its addresses from construction to
    the end. Returns the programs called."""
    def state():
        out = _tensors(engine._cache) + (("counts",
                                          engine._counts.data_ptr()),)
        if engine._dcache is not None:
            out += _tensors(engine._dcache)
        return out

    def donated(spec, args):
        out = ()
        for what in spec.donated:
            if what in ("cache", "pool cache"):
                out += _tensors(engine._cache)
            elif what == "draft cache":
                out += _tensors(engine._dcache)
            elif what == "counts":
                out += (("counts", engine._counts.data_ptr()),)
            else:
                assert what in ("row cache", "draft row cache"), what
                out += _tensors(args[2])
        return out

    calls, moved = collections.Counter(), []
    for attr in sorted({p.attr for p in t_reg.HOT_PROGRAMS}):
        if not hasattr(engine, attr):
            continue    # a draft's programs, on an engine without one
        fn = getattr(engine, attr)
        spec = t_reg.program(fn.__name__[len("ledger["):-1])

        def wrapped(*args, _fn=fn, _spec=spec):
            before = donated(_spec, args)
            out = _fn(*args)
            calls[_spec.name] += 1
            if donated(_spec, args) != before:
                moved.append(_spec.name)
            return out

        setattr(engine, attr, wrapped)
    init = state()
    engine.warmup()
    _serve(engine, queue, lambda p: Request(model="t", payload=p,
                                            slo_ms=6e4))
    assert moved == []
    assert state() == init
    return set(calls)


@pytest.mark.parametrize("arm", list(ARMS))
def test_donated_state_keeps_its_address(models, arm):
    engine, queue = _port_engine(models, arm)
    called = _held_addresses(engine, queue)
    required = {p.name for p in t_reg.required_for(
        engine.chunked_prefill, engine.paged, False)}
    assert required | _long_fill(engine) <= called


# --- speculative engines ------------------------------------------------------
DRAFT_LONG = {"draft_long_chunk", "draft_long_commit"}


@pytest.mark.parametrize("arm", list(ARMS))
def test_spec_donated_state_keeps_its_address(models, arm):
    """A self-draft engine on each arm: the draft cache, which the verify,
    catch-up, prefill and long-fill commit update in place, keeps its
    addresses through warmup and serving like the target's state."""
    engine, queue = _port_engine(models, arm, draft=True)
    called = _held_addresses(engine, queue)
    required = {p.name for p in t_reg.required_for(
        engine.chunked_prefill, engine.paged, True)}
    assert required | _long_fill(engine) | DRAFT_LONG <= called
    assert engine.spec_rounds > 0 and engine.draft_catchups > 0


@pytest.mark.parametrize("arm", list(ARMS))
def test_spec_warmup_covers_serving_like_the_reference(models, arm):
    """A self-draft engine on each arm against the JAX engine with the
    same draft: warmup covers ``required_for(..., has_draft=True)``; the
    names warmed are the JAX engine's plus the long fill's and the
    draft's long-fill pairs, which the port warms and the JAX engine
    compiles at the first long or chunked admission (steady-state
    compiles there, read off its ledger: nothing else); serving adds
    zero steady episodes, and greedy tokens equal the JAX engine's."""
    kv, knobs = ARMS[arm]
    jm, params, _tm = models[kv]
    jl = j_ledger.get_ledger()
    jl.reset()
    try:
        jq = JQueue("j", max_len=256)
        je = JEngine(jm, params, jq, draft_model=jm, draft_params=params,
                     spec_tokens=3, **{**BASE, **knobs})
        je.warmup()
        j_warm = set(jl.counts(phase=j_ledger.PHASE_WARMUP)) - {UNATTRIBUTED}
        j_tokens = _serve(je, jq, lambda p: JRequest(model="j", payload=p,
                                                     slo_ms=6e4))
        j_steady = {v["fn"] for v in jl.violations()} - {UNATTRIBUTED}
    finally:
        jl.reset()
    tl = get_ledger()
    tl.reset()
    try:
        engine, queue = _port_engine(models, arm, draft=True)
        engine.warmup()
        t_warm = set(tl.counts(phase=PHASE_WARMUP))
        t_tokens = _serve(engine, queue, lambda p: Request(
            model="t", payload=p, slo_ms=6e4))
        violations = tl.violations()
    finally:
        tl.reset()
    required = {p.name for p in t_reg.required_for(
        engine.chunked_prefill, engine.paged, True)}
    lazy = _long_fill(engine) | DRAFT_LONG
    assert required <= t_warm
    assert t_warm == j_warm | lazy
    assert violations == []
    # JAX's compile cache is process-wide: a ``commit_row`` an earlier
    # engine of this process compiled at the same shapes records no
    # episode, while the draft's chunk program (a closure per engine)
    # always does.
    assert {"draft_long_chunk"} <= j_steady <= lazy
    assert t_tokens[:10] == j_tokens[:10]     # the greedy requests
    if engine.paged:
        engine._allocator.check()
        assert engine._allocator.free_pages == engine.num_pages


def _spec_required_cases():
    for arm, (_kv, knobs) in ARMS.items():
        chunked = knobs["chunked_prefill"]
        paged = knobs.get("paged", False)
        for p in t_reg.required_for(chunked, paged, True):
            if p.arm in (t_reg.ARM_SPEC, t_reg.ARM_SPEC_MONO):
                yield arm, p.name


@pytest.mark.parametrize("arm,program", list(_spec_required_cases()))
def test_spec_warmup_stripped_of_a_program_raises(models, arm, program):
    engine, _queue = _port_engine(models, arm, draft=True)
    spec = t_reg.program(program)
    setattr(engine, spec.attr, getattr(engine, spec.impl))
    with pytest.raises(RuntimeError, match=f"warmup coverage gap.*{program}"):
        engine.warmup()
