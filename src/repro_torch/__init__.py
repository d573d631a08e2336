"""APS-LDA's topic-serving path in PyTorch, with hand-written CUDA kernels.

The port of the JAX package ``repro`` to PyTorch on an NVIDIA H100
(``sm_90a``).  Module layout mirrors ``repro``; the port imports neither
jax nor ``repro``.  Entry points run on the card unless the caller passes
``device="cpu"``; on a CUDA tensor every kernel of the path
(``kernels/csrc``) is the hand-written one, on a CPU tensor its plain
PyTorch version runs.
"""
