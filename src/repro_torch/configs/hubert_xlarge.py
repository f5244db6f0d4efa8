"""HuBERT-XLarge [audio] — 48L d_model=1280 16H (kv=16, MHA) d_ff=5120
vocab=504 — encoder-only, wav2vec2-style. [arXiv:2106.07447]

Backbone only: the CNN feature extractor is a stub; input_specs() provides
frame embeddings (B, S, 1280). Encoder-only => no decode shapes
(decode_32k / long_500k skipped per assignment). Training objective here is
masked-frame prediction over the 504-codebook vocab (HuBERT-style CE).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    head_dim=80,
    causal=False,
    encoder_only=True,
    norm="ln",
    embed_inputs=False,
)
