"""Speculative decoding on a tensor-parallel slab engine against the JAX
package's spec engine on the same mesh (CPU, f32): the tp 4 cases of
``test_torch_tp_spec.py`` (its helpers and fixtures), on a gloo world of 4
CPU ranks spawned once for this file. At tp 4 the draft's two kv heads
replicate while q is cut.
"""

from __future__ import annotations

import pytest

from tests import test_torch_tp_spec as base

models = base.models
TP = 4


@pytest.fixture(scope="module")
def world():
    yield from base.world_of(TP)


@pytest.mark.timeout(240)
@pytest.mark.parametrize("tp,draft,arm",
                         [c for c in base.CASES if c[0] == TP])
def test_tp_spec_matches_jax_spec_engine_on_the_mesh(models, world, tp,
                                                     draft, arm):
    base.check_case(models, world, tp, draft, arm)
