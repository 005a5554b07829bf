"""The kernel build cache switch, ``utils/compile_cache.py`` (CPU).

With ``compilation_cache_dir`` set, ``maybe_enable()`` points
``ops/_build.py``'s build directory at it (idempotently, and a library's
path there still carries the hash of its sources and flags); unset, the
builds stay in the checkout's ``build/torch_kernels/``. The decode engine,
``ModelHost`` and both profilers turn it on, as the reference's entry
points do. The same ``RDB_COMPILATION_CACHE_DIR`` variable drives both
packages' fields. Nothing is compiled here.
"""

from pathlib import Path

import pytest
import torch

from ray_dynamic_batching_tpu.utils import config as j_config
from ray_dynamic_batching_tpu_torch.ops import _build
from ray_dynamic_batching_tpu_torch.utils import compile_cache
from ray_dynamic_batching_tpu_torch.utils.config import (
    RDBConfig,
    reset_config,
    set_config,
)

DEFAULT = Path(_build.__file__).resolve().parents[2] / "build" / "torch_kernels"


@pytest.fixture
def restore():
    yield
    reset_config()
    _build.BUILD_DIR = DEFAULT
    compile_cache._applied = None


def test_unset_leaves_the_checkouts_build_dir(restore, monkeypatch):
    monkeypatch.delenv("RDB_COMPILATION_CACHE_DIR", raising=False)
    set_config(RDBConfig.from_env())
    assert RDBConfig.from_env().compilation_cache_dir == ""
    assert compile_cache.maybe_enable() is False
    assert _build.BUILD_DIR == DEFAULT
    assert _build._lib_path("flash_attention").parent == DEFAULT


def test_set_points_the_builds_at_the_cache(restore, tmp_path):
    cache = str(tmp_path / "kernels")
    set_config(RDBConfig.from_env(compilation_cache_dir=cache))
    assert compile_cache.maybe_enable() is True
    assert compile_cache.maybe_enable() is True       # idempotent
    assert _build.BUILD_DIR == Path(cache)
    path = _build._lib_path("decode_attention")
    assert path.parent == Path(cache)
    assert path.name.startswith("libdecode_attention-")
    assert path.name == (DEFAULT / path.name).name    # same key anywhere


def test_env_variable_reads_like_the_jax_packages(restore, monkeypatch,
                                                  tmp_path):
    monkeypatch.setenv("RDB_COMPILATION_CACHE_DIR", str(tmp_path))
    assert (RDBConfig.from_env().compilation_cache_dir
            == j_config.RDBConfig.from_env().compilation_cache_dir
            == str(tmp_path))


def test_entry_points_turn_it_on(restore, tmp_path):
    from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
    from ray_dynamic_batching_tpu_torch.engine.host import ModelHost
    from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
    from ray_dynamic_batching_tpu_torch.models import causal_lm as t_lm
    from ray_dynamic_batching_tpu_torch.profiles.decode_profiler import (
        DecodeProfiler,
    )
    from ray_dynamic_batching_tpu_torch.profiles.profiler import (
        ModelProfiler,
    )

    tm = t_lm.CausalLM(t_lm.TINY_LM, name="llama_tiny", dtype=torch.float32,
                       device="cpu", seed=0)
    entries = [
        lambda d: ModelHost(device="cpu"),
        lambda d: ModelProfiler(tm),
        lambda d: DecodeProfiler(tm),
        lambda d: DecodeEngine(tm, RequestQueue("llama_tiny"), num_slots=2,
                               max_len=32, prompt_buckets=[8],
                               device="cpu"),
    ]
    for i, make in enumerate(entries):
        cache = tmp_path / f"c{i}"
        set_config(RDBConfig.from_env(compilation_cache_dir=str(cache)))
        make(cache)
        assert _build.BUILD_DIR == cache, i
