"""repro_torch.kernels — hand-written CUDA kernels for Hopper (``csrc/``),
their wrappers (``ops``) and their plain PyTorch versions (``ref``).

All six kernels of the reference: ``ops.threshold_matmul``,
``ops.conv_threshold`` (the module ``conv_threshold`` holds its host
helpers), ``ops.mlp_megakernel``, ``ops.flash_attention``,
``ops.multi_threshold`` and ``ops.qmatmul``; and ``ops.float_head``,
the deployed float head with a fixed reduction order. Nothing here
builds a kernel at import time; ``_build`` compiles a source the first
time its wrapper sees a CUDA tensor.
"""

from repro_torch.kernels import ops, ref  # noqa: F401
