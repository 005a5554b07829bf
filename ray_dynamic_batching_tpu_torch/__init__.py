"""PyTorch/CUDA port of ``ray_dynamic_batching_tpu``.

A sibling package with the same layout (``ops/``, ``models/``, ``engine/``,
``serve/``, ``utils/``) and the same module names, so each module's JAX
counterpart is found by path. It imports ``torch`` and numpy only — never
JAX, flax, or anything of the JAX package; where it needs a JAX-free
module of that package it keeps its own copy.

Entry points (:class:`~.serve.llm.LLMDeployment`,
:class:`~.engine.decode.DecodeEngine`, :func:`~.models.base.get_model`)
default to ``device="cuda"`` and raise when CUDA is missing; the CPU runs
only when a caller asks for it with ``device="cpu"``.
"""
