"""H2O-Danube-1.8B [dense] — 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000 — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf]

SWA window 4096 (mistral-style) => sub-quadratic => long_500k RUNS for this
arch; decode uses a ring-buffer KV cache of window size.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab=32000,
    head_dim=80,
    window=4096,
)
