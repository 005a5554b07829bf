"""The port's pytree paths against ``jax.tree_util`` (CPU).

``utils/pytree.py`` walks trees without JAX; the checkpoint format stays
readable by both packages only if its keys, their order and the manifest's
``treedef`` string are JAX's. Held here on llama_tiny's params tree, on
mixed containers (lists, tuples, ``None``, empty nodes, integer-named
keys that sort as strings) and on collisions, which both refuse.
"""

import jax
import numpy as np
import pytest

from ray_dynamic_batching_tpu.models import causal_lm as j_lm
from ray_dynamic_batching_tpu.utils import pytree as j_pytree
from ray_dynamic_batching_tpu_torch.utils import pytree as t_pytree


def _llama_params():
    jm = j_lm.CausalLM(j_lm.TINY_LM, name="llama_tiny",
                       dtype=jax.numpy.float32)
    return jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))


MIXED = [
    {"b": [1, (2, 3)], "a": {"z": None, "y": np.ones(2)}, "c": (),
     "d": (5,), "e": [None, {}]},
    {"layer10": {"k": 1}, "layer2": {"k": 2}, "layer1": [np.zeros(1), 3]},
    [np.arange(3), {"x": (np.ones(1), None, [7])}],
    (np.float32(1.5),),
    {"opt": ({"mu": {"w": np.ones(2)}}, {"count": np.int32(4)})},
]


@pytest.mark.parametrize("tree", [_llama_params()] + MIXED,
                         ids=["llama_tiny"] + [f"mixed{i}"
                                               for i in range(len(MIXED))])
def test_keys_order_and_treedef_equal_jax(tree):
    want = j_pytree.flatten_with_paths(tree)
    got = t_pytree.flatten_with_paths(tree)
    assert list(got) == list(want)
    assert all(got[k] is want[k] for k in want)
    with_path = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [t_pytree.path_str(p) for p, _ in with_path] == list(got)
    assert t_pytree.treedef_str(tree) == str(
        jax.tree_util.tree_structure(tree))
    leaves = [f"leaf{i}" for i in range(len(got))]
    assert t_pytree.unflatten_like(tree, leaves) == \
        jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tree),
                                     leaves)


@pytest.mark.parametrize("tree", [
    {"a": {"b": 1}, "a/b": 2},
    {"x": [1, 2], "x/0": 3},
])
def test_collision_raises_in_both(tree):
    with pytest.raises(ValueError, match="collision"):
        j_pytree.flatten_with_paths(tree)
    with pytest.raises(ValueError, match="collision"):
        t_pytree.flatten_with_paths(tree)
