"""The benchmark of the PyTorch/CUDA port (``spacemesh_tpu_torch``).

``run.py`` is its command; ``BENCHMARK.json`` at the root names the cells.
"""
