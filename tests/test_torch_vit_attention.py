"""ViT attention on the port's flash path against the JAX package (CPU, f32).

ViT-B/16 hands the flash kernel q/k/v [B, 197, 12, 64] and ViT-G/14
[B, 257, 16, 104], both as views of one packed qkv projection (strided
over tokens, heads ``H`` apart), unmasked and non-causal. On the card the
kernel reads the views in place; here the wrapper runs its plain version,
which these tests hold to the JAX package on the same numpy inputs:

- ``flash_attention_plain`` on the packed views equals it on contiguous
  copies, bit for bit (the views change no arithmetic);
- ``ops/attention.py::dot_product_attention`` equals the JAX package's at
  both shapes to 1e-5 (f32 softmax of unit-scale scores, summed in another
  order);
- ViT-G/14's configuration at full width and 2 layers (224, batch 1), built
  from the JAX params through ``models/convert.py``, gives logits within
  1e-4 x max|logit| of the JAX ``ViTModule`` (the tolerance of the other
  vision models' parity tests);
- the shape rules: the route, the wrapper's layout rule (which views go in
  as they are, which are copied) and its head-dim refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_dynamic_batching_tpu.models import vit as j_vit
from ray_dynamic_batching_tpu.ops import attention as j_attention
from ray_dynamic_batching_tpu_torch.models import convert
from ray_dynamic_batching_tpu_torch.models import vit as t_vit
from ray_dynamic_batching_tpu_torch.ops import attention
from ray_dynamic_batching_tpu_torch.ops import flash_attention as fl

torch.set_num_threads(2)

# (B, T, N, H): ViT-B/16's and ViT-G/14's attention at batch 2.
SHAPES = [(2, 197, 12, 64), (2, 257, 16, 104)]
VIT_G = dict(patch_size=14, hidden_dim=1664, num_heads=16, mlp_dim=8192,
             num_layers=2)


def _packed(B, T, N, H, seed, dtype=torch.float32):
    """q, k, v as ``models/vit.py`` makes them: views of one [B, T, 3 N H]
    projection, plus the numpy array behind it."""
    a = np.random.default_rng(seed).standard_normal(
        (B, T, 3 * N * H)).astype(np.float32)
    qkv = torch.from_numpy(a).to(dtype)
    return qkv.view(B, T, 3, N, H).unbind(2), a.reshape(B, T, 3, N, H)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_on_packed_views_equals_contiguous_copies(shape, dtype):
    (q, k, v), _ = _packed(*shape, seed=1, dtype=dtype)
    assert not q.is_contiguous() and q.stride(2) == shape[3]
    got = fl.flash_attention_plain(q, k, v)
    want = fl.flash_attention_plain(q.contiguous(), k.contiguous(),
                                    v.contiguous())
    assert got.shape == shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_dot_product_attention_matches_jax(shape):
    (q, k, v), a = _packed(*shape, seed=2)
    want = np.asarray(j_attention.dot_product_attention(
        jnp.asarray(a[:, :, 0]), jnp.asarray(a[:, :, 1]),
        jnp.asarray(a[:, :, 2])))
    before = fl.launches
    got = attention.dot_product_attention(q, k, v).numpy()
    assert fl.launches == before      # the CPU runs the plain version
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_vit_g14_two_layers_matches_jax():
    jm = j_vit.ViT(image_size=224, dtype=jnp.float32, name="vit_g_14",
                   **VIT_G)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0)))
    tm = t_vit.ViT(image_size=224, dtype=torch.float32, device="cpu",
                   seed=None, name="vit_g_14", **VIT_G)
    tm.load_state_dict(convert.vit_params_from_flax(params))
    x = np.random.default_rng(5).standard_normal((1, 224, 224, 3)).astype(
        np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.inference_mode():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 1000)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def test_vit_g14_attention_takes_the_flash_route():
    """257 tokens of head_dim 104 go to the flash kernel on the card (the
    reference declines them to XLA on the TPU)."""
    assert (224 // 14) ** 2 + 1 == 257
    assert attention.route((32, 257, 16, 104), (32, 257, 16, 104),
                           causal=False) == "flash"


@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_layout_reads_packed_views_in_place(shape):
    (q, k, v), _ = _packed(*shape, seed=3, dtype=torch.bfloat16)
    for t in (q, k, v):
        assert fl._kernel_layout(t) is t
    # A last dim that is not contiguous, heads not H apart, a token
    # stride that is not whole 16-byte chunks: copied.
    B, T, N, H = shape
    bf = dict(dtype=torch.bfloat16)
    last_dim = torch.randn((B, T, H, N)).to(**bf).transpose(2, 3)
    heads_apart = torch.randn((B, T, N, 2 * H)).to(**bf)[..., :H]
    odd_tokens = torch.randn((B, T, N * H + 4)).to(**bf)[..., :N * H].view(
        B, T, N, H)
    for t in (last_dim, heads_apart, odd_tokens):
        out = fl._kernel_layout(t)
        assert out is not t and out.is_contiguous() and torch.equal(out, t)


@pytest.mark.parametrize("H", [100, 136, 0])
def test_launch_refuses_head_dims_the_kernel_does_not_take(H):
    q = torch.zeros((1, 16, 2, H))
    with pytest.raises(ValueError, match="head_dim"):
        fl._launch(q, q, q, None, causal=False, scale=1.0)
