"""Jamba-v0.1-52B [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2 — Mamba+attention 1:7 interleave, MoE
every other layer. [arXiv:2403.19887; hf]

Block structure (period 8): layers 0-7 with attention at index 4 (1:7
attn:mamba), MoE FFN on odd layers (every other), dense FFN on even.
ssm_state=16, d_inner=8192. long_500k RUNS (only 4 attention layers hold a
full-length KV cache; mamba state is O(1)).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    head_dim=128,
    moe_experts=16,
    moe_top_k=2,
    moe_every=2,
    attn_every=8,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    ssm_chunk=128,
)
