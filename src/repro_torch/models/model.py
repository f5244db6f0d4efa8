"""Top-level LM: init / prefill / decode for the dense attention configs.

The counterpart of ``repro.models.model.Model``'s inference entry points:

  * ``prefill``      -> the full-sequence forward (the reference's
                        prefill_32k target), float32 logits;
  * ``cache_init`` / ``decode_step`` -> one token per sequence against a
                        KV cache (decode_32k / long_500k; the ring buffer
                        for sliding-window configs).

Tensors live on the card unless the caller passes ``device="cpu"``; asking
for the card without one raises. Every entry point runs under
``torch.inference_mode()``. ``params_from_numpy`` carries the reference's
weights across (the tests feed both sides the same numbers). Training
(``train_logits``, ``loss``) and ``quantize_params`` are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.qir import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (_dtype, check_supported, embed_apply,
                                       embed_init, head_apply, norm_apply,
                                       norm_init)


def params_from_numpy(tree, cfg: ArchConfig, device=None):
    """The reference's ``Model.init`` pytree, every leaf converted to a
    numpy array, as the port's tensors: same nesting, same stacked
    ``n_groups`` axis, each leaf in ``cfg.dtype`` on ``device`` (None: the
    card). Convert JAX bf16 leaves to float32 first: ``np.asarray`` of one
    gives an ``ml_dtypes`` array that torch does not take."""
    dev = resolve_device(device)
    dtype = _dtype(cfg)

    def conv(x):
        if isinstance(x, dict):
            if "w_int" in x:
                raise NotImplementedError("the int8 serve path (w_int "
                                          "params) is not ported yet")
            return {k: conv(v) for k, v in x.items()}
        arr = np.asarray(x)
        if arr.dtype.kind != "f":
            raise TypeError(f"expected a float array, got {arr.dtype}")
        return torch.tensor(arr, dtype=dtype, device=dev)

    return conv(tree)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def __post_init__(self):
        check_supported(self.cfg)

    # -- params --------------------------------------------------------
    @torch.inference_mode()
    def init(self, generator: torch.Generator, device=None) -> Dict[str, Any]:
        """Random weights with the reference's distributions, drawn from
        ``generator``, which must live on ``device`` (None: the card)."""
        dev = resolve_device(device)
        cfg = self.cfg
        p: Dict[str, Any] = {"embed": embed_init(generator, cfg, device=dev),
                             "blocks": tfm.stack_init(generator, cfg,
                                                      device=dev),
                             "final_norm": norm_init(cfg, device=dev)}
        if not cfg.tie_embeddings:
            head = torch.empty((cfg.d_model, cfg.vocab), dtype=torch.float32,
                               device=dev).normal_(generator=generator)
            p["head"] = {"w": head.mul_(cfg.d_model ** -0.5).to(_dtype(cfg))}
        return p

    # -- forward ---------------------------------------------------------
    def _inputs_to_h(self, params, batch):
        tokens = batch["tokens"]
        h = embed_apply(self.cfg, params["embed"], tokens)
        B, S = tokens.shape
        if "positions" in batch:
            positions = batch["positions"]
        else:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=h.device)[None].expand(B, S)
        return h, positions

    def _head(self, params, h):
        h = norm_apply(self.cfg, params["final_norm"], h)
        return head_apply(self.cfg, params["embed"] if self.cfg.tie_embeddings
                          else params["head"], h)

    # -- inference ---------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, params, batch) -> torch.Tensor:
        """Full-sequence forward: batch {"tokens": (B, S) int} (optional
        "positions" (B, S)) -> logits (B, S, V) float32."""
        h, positions = self._inputs_to_h(params, batch)
        h = tfm.stack_apply(self.cfg, params["blocks"], h, positions)
        return self._head(params, h)

    @torch.inference_mode()
    def cache_init(self, batch: int, max_len: int, dtype=None, device=None):
        """Zeroed KV caches, stacked (n_groups, batch, ...) per leaf."""
        dev = resolve_device(device)
        one = tfm.block_cache_init(self.cfg, batch, max_len, dtype,
                                   device=dev)
        return tfm.map_tree(
            lambda x: x.unsqueeze(0).repeat(self.cfg.n_groups,
                                            *([1] * x.dim())), one)

    @torch.inference_mode()
    def decode_step(self, params, caches, tokens, cur_index):
        """One token for every sequence in the batch.

        tokens (B, 1) int; cur_index an int or a (B,) tensor of per-slot
        positions. Returns (logits (B, 1, V) float32, caches), the caches
        updated in place."""
        h = embed_apply(self.cfg, params["embed"], tokens)
        h, caches = tfm.stack_decode(self.cfg, params["blocks"], caches, h,
                                     cur_index)
        return self._head(params, h), caches
