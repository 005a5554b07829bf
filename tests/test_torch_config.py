"""The port's configuration against the JAX package's (CPU).

Every field the port keeps has the JAX package's default and reads the
same ``RDB_<NAME>`` variable with the same coercion, so one environment
drives both packages alike. The fields the port trims are not there.
"""

import dataclasses

import pytest

from ray_dynamic_batching_tpu.utils import config as j_config
from ray_dynamic_batching_tpu_torch.utils import config as t_config

PORT_FIELDS = [f.name for f in dataclasses.fields(t_config.RDBConfig)]

# A value unlike each default, written as the environment carries it.
OVERRIDES = {int: "7", float: "0.375", bool: "0", str: "x"}

TRIMMED = ("compile_cost_default_ms", "compile_amortization_intervals",
           "health_check_timeout_ms", "discard_stale_requests",
           "health_check_period_ms", "actor_max_restarts")


@pytest.mark.parametrize("name", PORT_FIELDS)
def test_kept_field_matches_the_reference(name, monkeypatch):
    ref = j_config.RDBConfig()
    port = t_config.RDBConfig()
    assert getattr(port, name) == getattr(ref, name)
    monkeypatch.setenv("RDB_" + name.upper(),
                       OVERRIDES[type(getattr(ref, name))])
    j_env = j_config.RDBConfig.from_env()
    t_env = t_config.RDBConfig.from_env()
    assert getattr(t_env, name) == getattr(j_env, name)
    assert getattr(t_env, name) != getattr(port, name)


@pytest.mark.parametrize("name", TRIMMED)
def test_trimmed_field_is_absent(name):
    assert hasattr(j_config.RDBConfig(), name)
    assert not hasattr(t_config.RDBConfig(), name)


def test_set_and_reset_config(monkeypatch):
    monkeypatch.delenv("RDB_HBM_BUDGET_BYTES", raising=False)
    t_config.reset_config()
    try:
        t_config.set_config(t_config.RDBConfig.from_env(
            hbm_budget_bytes=80 << 30))
        assert t_config.get_config().hbm_budget_bytes == 80 << 30
        t_config.reset_config()
        assert t_config.get_config().hbm_budget_bytes == 14 << 30
    finally:
        t_config.reset_config()
