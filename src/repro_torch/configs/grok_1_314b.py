"""Grok-1-314B [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2 (every layer). [hf:xai-org/grok-1]

head_dim = 6144/48 = 128. The 8x(3*6144*32768) expert FFNs dominate the
param count (~309B of 314B).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131072,
    head_dim=128,
    moe_experts=8,
    moe_top_k=2,
    moe_every=1,
)
