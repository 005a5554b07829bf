"""The port's vision servables, converters and profiler against the JAX
package's (CPU, f32).

- The four tiny models (``resnet18_tiny``, ``shufflenet_tiny``,
  ``efficientnet_tiny``, ``vit_tiny``): flax params from
  ``init(PRNGKey(0))`` (BatchNorm statistics replaced by numpy draws, so
  the converter's ``mean``/``var`` matter), converted by
  ``models/convert.py``, and numpy inputs from a seed give logits within
  1e-4 x max|logit| of the JAX model's (the same f32 math summed in
  another order), and the same top-1.
- SAME padding: a strided block of each CNN family gets an odd- and an
  even-sized input (flax pads (1, 1) and (0, 1) there).
- At full width (no forward of the weights: shapes from ``jax.eval_shape``
  and torch's meta device): parameter counts and output shapes equal.
- ``ModelProfiler.sweep`` on a tiny model writes the three outputs, and
  both packages' ``BatchProfile`` read them back.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_dynamic_batching_tpu.models import efficientnet as j_eff
from ray_dynamic_batching_tpu.models import registry as j_reg
from ray_dynamic_batching_tpu.models import resnet as j_resnet
from ray_dynamic_batching_tpu.models import shufflenet as j_shuffle
from ray_dynamic_batching_tpu.profiles.table import BatchProfile as JProfile
from ray_dynamic_batching_tpu_torch.models import convert
from ray_dynamic_batching_tpu_torch.models import efficientnet as t_eff
from ray_dynamic_batching_tpu_torch.models import layers
from ray_dynamic_batching_tpu_torch.models import registry as t_reg
from ray_dynamic_batching_tpu_torch.models import resnet as t_resnet
from ray_dynamic_batching_tpu_torch.models import shufflenet as t_shuffle
from ray_dynamic_batching_tpu_torch.ops import attention
from ray_dynamic_batching_tpu_torch.profiles.profiler import ModelProfiler
from ray_dynamic_batching_tpu_torch.profiles.table import BatchProfile

torch.set_num_threads(2)

TINY = {
    "resnet18_tiny": convert.resnet_params_from_flax,
    "shufflenet_tiny": convert.shufflenet_params_from_flax,
    "efficientnet_tiny": convert.efficientnet_params_from_flax,
    "vit_tiny": convert.vit_params_from_flax,
}
FULL = ["resnet50", "shufflenet_v2", "efficientnet_v2s", "vit_b_16"]


def _numpy_stats(params, seed: int):
    """The params tree as numpy, with BatchNorm statistics drawn from a
    seed (mean N(0, 0.1), var U(0.75, 1.25)) instead of init's 0 / 1."""
    params = jax.tree_util.tree_map(np.asarray, params)
    if "batch_stats" not in params:
        return params
    rng = np.random.default_rng(seed)

    def draw(path, a):
        if path[-1].key == "var":
            return rng.uniform(0.75, 1.25, a.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return {**params, "batch_stats": jax.tree_util.tree_map_with_path(
        draw, params["batch_stats"])}


def _close(got: np.ndarray, want: np.ndarray) -> None:
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


@pytest.fixture(scope="module")
def tiny():
    """name -> (JAX model, numpy params, port model with those weights)."""
    built = {}

    def get(name):
        if name not in built:
            jm = j_reg.get_model(name, dtype=jnp.float32)
            params = _numpy_stats(jm.init(jax.random.PRNGKey(0)), seed=3)
            tm = t_reg.get_model(name, dtype=torch.float32, device="cpu",
                                 seed=None)
            tm.load_state_dict(TINY[name](params))
            built[name] = (jm, params, tm.eval())
        return built[name]

    return get


@pytest.mark.parametrize("name", list(TINY))
def test_tiny_logits_match_jax(tiny, name):
    jm, params, tm = tiny(name)
    x = np.random.default_rng(7).standard_normal((4, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (4, 10)
    _close(got, want)
    assert (got.argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("name", list(TINY))
def test_converter_fills_every_weight(tiny, name):
    jm, params, tm = tiny(name)
    sd = TINY[name](params)
    assert set(sd) == set(tm.state_dict())
    assert tm.param_count() == jm.param_count(params)


@pytest.mark.parametrize("name", list(TINY))
def test_vision_forward_shapes(name):
    """Twin of ``tests/test_models.py::test_vision_forward_shapes``."""
    model = t_reg.get_model(name, dtype=torch.float32, device="cpu")
    (x,) = model.example_inputs(4)
    assert tuple(x.shape) == (4, 32, 32, 3)
    with torch.inference_mode():
        logits = model(x)
    assert logits.shape == (4, 10)
    assert torch.isfinite(logits).all()


def test_registry_contents_and_slos():
    names = t_reg.registered_models()
    for required in FULL + ["vit_g_14", "llama3_8b"] + list(TINY):
        assert required in names
    for name in FULL:
        assert (t_reg.get_slo(name).latency_slo_ms
                == j_reg.get_slo(name).latency_slo_ms)
    assert t_reg.get_slo("resnet50").latency_slo_ms == 2000.0


def test_seeded_weights_are_reproducible():
    a = t_reg.get_model("resnet18_tiny", device="cpu", seed=5)
    b = t_reg.get_model("resnet18_tiny", device="cpu", seed=5)
    c = t_reg.get_model("resnet18_tiny", device="cpu", seed=6)
    for key, t in a.state_dict().items():
        assert torch.equal(t, b.state_dict()[key])
    assert not torch.equal(a.stem_conv.weight, c.stem_conv.weight)
    assert a.stem_conv.weight.dtype == torch.bfloat16
    assert a.stem_bn.mean.dtype == torch.float32


@pytest.mark.parametrize("size,pads", [(15, (1, 1)), (16, (0, 1))])
def test_same_pads_rule(size, pads):
    assert layers.same_pads(size, 3, 2) == pads
    assert layers.same_pads(size, 3, 1) == (1, 1)
    assert layers.same_pads(size, 1, 2) == (0, 0)


def _blocks():
    kw = dict(dtype=torch.float32, device=torch.device("cpu"))
    return {
        "resnet_bottleneck": (
            j_resnet.BottleneckBlock(features=8, strides=2,
                                     dtype=jnp.float32),
            lambda: t_resnet.BottleneckBlock(16, 8, 2, **kw)),
        "shufflenet_down": (
            j_shuffle.ShuffleUnit(32, downsample=True, dtype=jnp.float32),
            lambda: t_shuffle.ShuffleUnit(16, 32, True, **kw)),
        "efficientnet_fused": (
            j_eff.MBConv("fused", 2, 24, 2, False, dtype=jnp.float32),
            lambda: t_eff.MBConv("fused", 16, 2, 24, 2, False, **kw)),
        "efficientnet_mbconv": (
            j_eff.MBConv("mbconv", 2, 24, 2, True, dtype=jnp.float32),
            lambda: t_eff.MBConv("mbconv", 16, 2, 24, 2, True, **kw)),
    }


@pytest.mark.parametrize("block", list(_blocks()))
@pytest.mark.parametrize("size", [15, 16])
def test_strided_block_same_padding(block, size):
    """An odd and an even input through a stride-2 block: torch's
    symmetric padding=1 would keep the shape and shift every window of
    the even one by a pixel."""
    j_block, make = _blocks()[block]
    x = np.random.default_rng(size).standard_normal(
        (2, size, size, 16)).astype(np.float32)
    params = _numpy_stats(j_block.init(jax.random.PRNGKey(1), x), seed=4)
    want = np.asarray(j_block.apply(params, jnp.asarray(x)))
    t_block = make()
    t_block.load_state_dict(convert._vision_from_flax(params, lambda n: n))
    with torch.inference_mode():
        got = t_block(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 8, 8, want.shape[-1])
    _close(got, want)


def test_vit_attention_takes_the_flash_route():
    """ViT-B/16 hands q/k/v [B, 197, 12, 64], non-causal, no mask, to the
    flash kernel on a card (kernel 1 is on the vision path)."""
    assert attention.route((64, 197, 12, 64), (64, 197, 12, 64),
                           causal=False) == "flash"
    jm_tokens = (224 // 16) ** 2 + 1
    assert jm_tokens == 197


@pytest.mark.parametrize("name", FULL)
def test_full_width_param_count_and_output_shape(name):
    jm = j_reg.get_model(name)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    j_count = sum(int(np.prod(leaf.shape))
                  for leaf in jax.tree_util.tree_leaves(shapes))
    (spec,) = jm.input_shapes(2)
    j_out = jax.eval_shape(jm.apply, shapes, spec)
    tm = t_reg.get_model(name, device="meta", seed=None)
    assert tm.param_count() == j_count
    (t_spec,) = tm.input_shapes(2)
    assert t_spec.shape == spec.shape
    with torch.inference_mode():
        out = tm(*tm.example_inputs(2))
    assert tuple(out.shape) == j_out.shape
    assert out.dtype == torch.float32 and j_out.dtype == jnp.float32
    assert tm.flops_per_sample() == jm.flops_per_sample()


def test_model_profiler_sweep_tiny(tmp_path):
    """Twin of ``tests/test_profiles.py::TestLiveProfiler``."""
    model = t_reg.get_model("vit_tiny", dtype=torch.float32, device="cpu")
    profiler = ModelProfiler(model, timing_iters=2, warmup_iters=1)
    prof = profiler.sweep(batch_buckets=[1, 2])
    assert [r.batch_size for r in prof.rows] == [1, 2]
    for row in prof.rows:
        assert row.latency_ms > 0
        assert row.compile_ms > 0
        assert row.hbm_bytes >= model.param_bytes()
        assert row.seq_len == 0
    assert all(r.throughput_sps > 0 for r in prof.rows)
    csv_path, json_path, report_path = profiler.write_outputs(
        prof, str(tmp_path))
    for path in (csv_path, json_path, report_path):
        assert os.path.exists(path)
    for table in (BatchProfile, JProfile):
        loaded = table.from_csv(model.name, csv_path)
        assert [r.batch_size for r in loaded.rows] == [1, 2]
        assert [r.hbm_bytes for r in loaded.rows] == [
            r.hbm_bytes for r in prof.rows]
