"""Llama-4-Scout-17B-16E [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 routed experts top-1 + shared expert (every layer),
early fusion. [hf:meta-llama/Llama-4-Scout-17B-16E]

head_dim = 128. Active params/token ~ 17B (1 routed + 1 shared expert).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    head_dim=128,
    moe_experts=16,
    moe_top_k=1,
    moe_every=1,
    moe_shared_expert=True,
    rope_theta=5e5,
)
