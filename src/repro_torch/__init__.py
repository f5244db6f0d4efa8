"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

Imports ``torch`` and ``numpy`` only: never ``jax`` and nothing of the JAX
package ``repro``, which stays the reference the port is tested against.
Its entry points run on the CUDA card unless the caller passes
``device="cpu"``. Ported so far: the integer-dataflow path (``core``,
``deploy``, ``obs``) on the hand-written ``threshold_matmul``,
``conv_threshold`` and ``mlp_megakernel`` kernels, and the LM inference
path (``configs``, ``models``, ``serving``) on the hand-written
``flash_attention`` kernel (``kernels``).
"""
