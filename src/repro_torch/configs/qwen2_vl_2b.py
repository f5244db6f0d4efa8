"""Qwen2-VL-2B [vlm] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — M-RoPE, dynamic resolution. [arXiv:2409.12191; hf]

Backbone only: the vision frontend is a stub; input_specs() provides
precomputed patch embeddings + (3, B, S) M-RoPE positions.
head_dim = 1536/12 = 128; M-RoPE sections (t,h,w) = (16, 24, 24) over the
64 rotary half-dims, matching the HF config.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    head_dim=128,
    mrope=True,
    mrope_sections=(16, 24, 24),
    qkv_bias=True,
    rope_theta=1e6,
    embed_inputs=False,   # patch/frame embeddings provided by the stub
    tie_embeddings=False,
)
