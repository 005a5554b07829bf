"""Nothing the benchmark runs loads JAX or the JAX package; top-level
module names are compared whole."""

import ast
import subprocess
import sys
from pathlib import Path

from gpubench import harness

BENCH = Path(__file__).resolve().parents[1]


def test_top_level_names_compared_whole():
    names = ["ray_dynamic_batching_tpu_torch", "ray_dynamic_batching_tpu_torch.serve.llm",
             "jaxtyping", "flaxen", "jaxlib_helper", "torch"]
    assert harness.forbidden_modules(names) == []
    bad = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
           "ray_dynamic_batching_tpu", "ray_dynamic_batching_tpu.serve"]
    assert harness.forbidden_modules(names + bad) == sorted(bad)


def test_the_harness_and_the_port_load_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from gpubench import harness, reference, devtrace, traffic\n"
        "import ray_dynamic_batching_tpu_torch.serve.llm\n"
        "import ray_dynamic_batching_tpu_torch.serve.router\n"
        "import ray_dynamic_batching_tpu_torch.serve.handle\n"
        "import ray_dynamic_batching_tpu_torch.serve.controller\n"
        "print(harness.forbidden_modules(list(sys.modules)))\n"
    ) % str(BENCH.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "costs.py", "traffic.py", "stats.py"):
        tops = {m.split(".")[0] for m in _imports(BENCH / name)}
        assert not tops & {"ray_dynamic_batching_tpu_torch", "jax", "flax",
                           "jaxlib", "ray_dynamic_batching_tpu"}, name
