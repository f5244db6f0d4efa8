"""Falcon-Mamba-7B [ssm] — 64L d_model=4096 (attention-free) vocab=65024,
ssm_state=16 — mamba1 architecture. [arXiv:2410.05355]

Pure SSM: no attention, no separate FFN (the mamba block IS the mixer+FFN,
d_inner = 2 * d_model = 8192, dt_rank = 4096/16 = 256, conv kernel 4).
long_500k RUNS for this arch (linear-time scan).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=65024,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    ssm_chunk=128,
)
