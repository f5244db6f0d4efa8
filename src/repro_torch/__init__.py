"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

Imports ``torch`` and ``numpy`` only: never ``jax`` and nothing of the JAX
package ``repro``, which stays the reference the port is tested against.
Its entry points run on the CUDA card unless the caller passes
``device="cpu"``. Ported so far: the offline integer-dataflow path
(``core``, ``deploy``, ``obs``) on the hand-written ``threshold_matmul``
and ``conv_threshold`` kernels (``kernels``).
"""
