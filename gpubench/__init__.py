"""The benchmark of the PyTorch/CUDA port (``ray_dynamic_batching_tpu_torch``).

``run.py`` is its command; see ``README.md``.
"""
