"""PyTorch + CUDA port of the ``repro`` model stack, for one NVIDIA H100.

The layout mirrors ``repro``: ``configs``, ``core``, ``kernels``, ``models``,
``runtime``, ``launch``.  The package imports ``torch`` and never ``jax``,
and keeps its own copies of what it needs from ``repro``.
"""
