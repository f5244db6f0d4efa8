"""Architecture config schema + input-shape definitions.

A copy of ``repro.configs.base`` (framework-free data, copied rather than
imported, so the port needs nothing of the JAX package). Every assigned
architecture is a frozen ``ArchConfig``; the four assigned input shapes
are ``ShapeConfig``s. ``reduced()`` produces the small same-family config
used by the CPU tests.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    # --- MoE ---------------------------------------------------------
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_every: int = 1           # MoE in every k-th layer (jamba: 2)
    moe_shared_expert: bool = False
    capacity_factor: float = 1.25
    # --- SSM (mamba1) --------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: Optional[int] = None   # default d_model // 16
    attn_every: int = 1          # hybrid: attention layer every k-th (jamba: 8)
    # --- attention flavour ----------------------------------------------
    rope_theta: float = 1e4
    mrope: bool = False          # qwen2-vl 3-section M-RoPE
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t/h/w halves of head_dim
    window: int = 0              # SWA window (h2o-danube)
    causal: bool = True
    encoder_only: bool = False
    qkv_bias: bool = False
    norm: str = "rms"            # rms | ln
    embed_inputs: bool = True    # False: input_specs provides embeddings (vlm/audio)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # --- quantization (the paper's technique, first-class) ---------------
    weight_bits: int = 16        # 16 = bf16 baseline; 8 / 4 = quantized serve path
    act_bits: int = 16
    # --- numerics / scan -------------------------------------------------
    dtype: str = "bfloat16"
    scan_layers: bool = True
    remat: str = "full"          # full | dots | none (hillclimb lever)
    ssm_chunk: int = 256
    attn_chunk: int = 1024       # flash-jnp q/kv chunk for long sequences
    attn_impl: str = "auto"      # auto | naive | chunked

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or max(self.d_model // 16, 1)

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    @property
    def block_period(self) -> int:
        """Layers per scanned block: lcm of the attn/moe interleave patterns."""
        import math

        p = 1
        if self.has_ssm and self.has_attention:
            p = math.lcm(p, self.attn_every)
        if self.is_moe:
            p = math.lcm(p, self.moe_every)
        return p

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.block_period == 0
        return self.n_layers // self.block_period

    def layer_kind(self, i: int) -> str:
        """'attn' or 'ssm' mixer for layer i within the repeating pattern."""
        if not self.has_ssm:
            return "attn"
        if not self.has_attention:
            return "ssm"
        # jamba: one attention layer per attn_every, placed mid-period
        return "attn" if (i % self.attn_every) == self.attn_every // 2 else "ssm"

    def layer_is_moe(self, i: int) -> bool:
        if not self.is_moe:
            return False
        return (i % self.moe_every) == self.moe_every - 1

    # ------------------------------------------------------------------
    def n_params(self) -> int:
        """Exact parameter count of this implementation (embedding included)."""
        d, f, V = self.d_model, self.d_ff, self.vocab
        H, K, hd = self.n_heads, self.n_kv_heads, self.hd
        nrm = 2 * d if self.norm == "ln" else d  # ln carries a bias
        total = V * d if self.embed_inputs else 0
        if not self.tie_embeddings:
            total += V * d                       # lm head
        total += nrm                             # final norm
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind == "attn":
                qkv = d * H * hd + 2 * d * K * hd + H * hd * d
                if self.qkv_bias:
                    qkv += (H + 2 * K) * hd
                total += qkv + nrm               # + attn norm
            else:
                di, st, dtr = self.d_inner, self.ssm_state, self.dt_rank
                total += (
                    d * 2 * di                   # in_proj
                    + di * self.ssm_conv + di    # depthwise conv + bias
                    + di * (dtr + 2 * st)        # x_proj
                    + dtr * di + di              # dt_proj
                    + di * st + di               # A_log, D
                    + di * d                     # out_proj
                    + nrm                        # norm
                )
            if self.d_ff > 0:
                if self.layer_is_moe(i):
                    total += self.moe_experts * 3 * d * f + d * self.moe_experts
                    if self.moe_shared_expert:
                        total += 3 * d * f
                else:
                    total += 3 * d * f
                total += nrm                     # mlp norm
        return total

    def n_active_params(self) -> int:
        """Params touched per token (MoE: top_k experts only) — the N in 6ND."""
        if not self.is_moe:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        dense_equiv = dataclasses.replace(self, moe_experts=0, moe_top_k=0)
        total = dense_equiv.n_params()
        n_moe_layers = sum(self.layer_is_moe(i) for i in range(self.n_layers))
        # dense_equiv counted 3*d*f per layer; replace MoE layers with top_k experts
        total += n_moe_layers * (self.moe_top_k - 1) * 3 * d * f
        total += n_moe_layers * d * self.moe_experts  # router
        if self.moe_shared_expert:
            total += n_moe_layers * 3 * d * f
        return total

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Same-family tiny config for CPU smoke tests."""
        period = self.block_period
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=max(period, 2 if period == 1 else period),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=128 if self.d_ff > 0 else 0,
            vocab=256,
            head_dim=16,
            moe_experts=min(self.moe_experts, 4) if self.is_moe else 0,
            moe_top_k=min(self.moe_top_k, 2) if self.is_moe else 0,
            ssm_state=min(self.ssm_state, 8) if self.has_ssm else 0,
            ssm_dt_rank=8 if self.has_ssm else None,
            window=min(self.window, 32) if self.window else 0,
            mrope_sections=(2, 3, 3) if self.mrope else self.mrope_sections,
            ssm_chunk=16,
            attn_chunk=32,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped) per the assignment rules."""
    if arch.encoder_only and shape.kind == "decode":
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k":
        sub_quadratic = arch.has_ssm or arch.window > 0
        if not sub_quadratic:
            return False, "pure full-attention arch: 500k decode needs sub-quadratic attention"
    return True, ""
