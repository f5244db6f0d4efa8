"""Top-level LM: init / forward / loss / prefill / decode for every
configuration of ``repro_torch.configs``: dense, MoE, mamba, the jamba
hybrid, and the vlm / audio backbones that take embeddings.

The counterpart of ``repro.models.model.Model``:

  * ``train_logits`` / ``loss`` -> the training forward (the reference's
                        train_4k target): float32 logits and the aux loss;
                        the loss is cross-entropy over ``labels >= 0``
                        plus a 1e-4 z-loss plus 1e-2 x aux, differentiable
                        through every layer (K6's backward kernel on the
                        chunked path);
  * ``prefill``      -> the full-sequence forward (the reference's
                        prefill_32k target), float32 logits;
  * ``cache_init`` / ``decode_step`` -> one token per sequence against a
                        KV cache (decode_32k / long_500k; the ring buffer
                        for sliding-window configs).

Tensors live on the card unless the caller passes ``device="cpu"``; asking
for the card without one raises. ``init`` returns ordinary tensors (made
under ``torch.no_grad()``), so training can take their gradients; called
under ``torch.inference_mode()``, as the serving callers do, it returns
inference tensors, whose views cost the host less on every decode step.
The inference entry points run under ``torch.inference_mode()``.
``params_from_numpy`` carries the reference's weights across (the tests
feed both sides the same numbers), quantized ones too.
``quantize_params`` makes the int8 serve path's tree: every linear as
int8 codes with per-output-channel float32 scales, which run on K5
(``layers.linear_apply``).

Inputs, as the reference takes them: text configs take ``tokens`` (B, S);
configs with ``embed_inputs=False`` (qwen2-vl, hubert: the frontend is a
stub) take ``embeds`` (B, S, d_model) and have no ``embed`` leaf. An
optional ``positions`` is (B, S), or (3, B, S) for M-RoPE.

Leaf dtypes are the reference's: ``cfg.dtype`` but for the MoE router's
weight, the mamba ``A_log``, ``D`` and ``dt_proj.b``, which are float32
in every config. ``layers.leaf_dtype`` alone decides this, for the inits
and for ``params_from_numpy``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.pytree import tree_map
from repro_torch.core.qir import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (_dtype, _mx, embed_apply, embed_init,
                                       embed_specs, head_apply, leaf_dtype,
                                       norm_apply, norm_init, norm_specs,
                                       quantize_linear_params)
from repro_torch.parallel.collectives import (gather_sequence_whole,
                                              max_over_group, sequence_block,
                                              sum_detached, sum_over_batch,
                                              sum_over_group)
from repro_torch.parallel.sharding import (active_mesh, batch_block,
                                           gather_leaf, logical_block,
                                           logical_group, logical_to_spec,
                                           sequence_group, spec_group)

def _lse_and_label_logit(logits, labels):
    """(log-sum-exp over the vocab, the label's logit) of float32 logits;
    labels < 0 give any logit (the loss masks them). Where the vocab is
    split the rank holds its block of the logits: the log-sum-exp is the
    group's max (a constant under the gradient) plus the log of the
    exponentials' sum over the group, and the label's logit is summed
    over the group from the one rank whose block holds it."""
    tp = logical_group("vocab")
    if tp is None:
        lse = torch.logsumexp(logits, dim=-1)
        return lse, torch.gather(logits, -1,
                                 labels.clamp_min(0)[..., None])[..., 0]
    rows = logits.shape[-1]
    m = max_over_group(logits.amax(dim=-1), tp)
    lse = m + torch.log(sum_over_group(
        torch.exp(logits - m[..., None]).sum(dim=-1), tp))
    local = labels - logical_block("vocab")[0] * rows
    mine = (local >= 0) & (local < rows)
    lab = torch.gather(logits, -1, local.clamp(0, rows - 1)[..., None])[..., 0]
    return lse, sum_over_group(torch.where(mine, lab, 0.0), tp)


def params_from_numpy(tree, cfg: ArchConfig, device=None):
    """The reference's ``Model.init`` pytree (or its ``quantize_params``
    tree), every leaf converted to a numpy array, as the port's tensors:
    same nesting, same stacked ``n_groups`` axis, each float leaf in the
    reference's dtype (``leaf_dtype``), ``w_int`` codes as int8 and
    ``w_scale`` as float32, on ``device`` (None: the card). Convert JAX
    bf16 leaves to float32 first: ``np.asarray`` of one gives an
    ``ml_dtypes`` array that torch does not take."""
    dev = resolve_device(device)

    def conv(x, path):
        if isinstance(x, dict):
            return {k: conv(v, path + (k,)) for k, v in x.items()}
        arr = np.asarray(x)
        if path[-1:] == ("w_int",):
            if arr.dtype != np.int8:
                raise TypeError(f"expected int8 w_int codes, got {arr.dtype}")
            return torch.tensor(arr, dtype=torch.int8, device=dev)
        if arr.dtype.kind != "f":
            raise TypeError(f"expected a float array, got {arr.dtype}")
        dtype = (torch.float32 if path[-1:] == ("w_scale",)
                 else leaf_dtype(cfg, path))
        return torch.tensor(arr, dtype=dtype, device=dev)

    return conv(tree, ())


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    # -- params --------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator, device=None) -> Dict[str, Any]:
        """Random weights with the reference's distributions, drawn from
        ``generator``, which must live on ``device`` (None: the card):
        ordinary tensors, or inference tensors under
        ``torch.inference_mode()``. On ``device="meta"`` the tree has its
        shapes and dtypes and no values, and nothing is allocated (the
        reference's ``jax.eval_shape(model.init, key)``); ``generator``
        may then be None."""
        dev = resolve_device(device)
        cfg = self.cfg
        p: Dict[str, Any] = {}
        if cfg.embed_inputs:
            p["embed"] = embed_init(generator, cfg, device=dev)
        p["blocks"] = tfm.stack_init(generator, cfg, device=dev)
        p["final_norm"] = norm_init(cfg, device=dev)
        if not cfg.tie_embeddings:
            head = torch.empty((cfg.d_model, cfg.vocab), dtype=torch.float32,
                               device=dev).normal_(generator=generator)
            p["head"] = {"w": head.mul_(cfg.d_model ** -0.5).to(_dtype(cfg))}
        return p

    def param_specs(self) -> Dict[str, Any]:
        """``init``'s tree with a spec tuple at every leaf, under the
        logical rules active at the call (``use_mesh_rules``)."""
        p: Dict[str, Any] = {"blocks": tfm.stack_specs(self.cfg),
                             "final_norm": norm_specs(self.cfg)}
        if self.cfg.embed_inputs:
            p["embed"] = embed_specs(self.cfg)
        if not self.cfg.tie_embeddings:
            p["head"] = {"w": (_mx("fsdp")[0], _mx("vocab")[0])}
        return p

    # -- forward ---------------------------------------------------------
    def _embed(self, params, tokens_or_embeds, seq=None):
        """Token ids through the table, or embeddings cast to the
        config's dtype (``embed_inputs=False``); ``seq``: the group over
        which the residual stream is split into sequence blocks, of which
        the rank's is returned."""
        if self.cfg.embed_inputs:
            return embed_apply(self.cfg, params["embed"], tokens_or_embeds,
                               seq)
        return sequence_block(tokens_or_embeds.to(_dtype(self.cfg)), seq)

    def _inputs_to_h(self, params, batch):
        """(h, positions, their offset): the caller's positions (offset
        None: the attention layers check them), or the arange built here
        (offset 0: nothing is read back from it). Under a mesh that
        splits the batch, of the rank's rows of the global batch; where
        the rules split the residual stream's sequence
        (``sequence_group``), h is the rank's block of it (the positions
        stay whole)."""
        x = batch_block(batch["tokens"] if self.cfg.embed_inputs
                        else batch["embeds"])
        B, S = x.shape[:2]
        h = self._embed(params, x, sequence_group(S))
        if "positions" in batch:
            pos = batch["positions"]
            return h, batch_block(pos, dim=pos.dim() - 2), None
        positions = torch.arange(S, dtype=torch.int32,
                                 device=h.device)[None].expand(B, S)
        return h, positions, 0

    def _head(self, params, h, seq=None):
        """Logits of the residual stream ``h``; ``seq``: h is the rank's
        block of the sequence, gathered before the final norm, so the
        logits and the loss are the whole sequence's."""
        h = gather_sequence_whole(h, seq)
        h = norm_apply(self.cfg, params["final_norm"], h)
        return head_apply(self.cfg, params["embed"] if self.cfg.tie_embeddings
                          else params["head"], h)

    def train_logits(self, params, batch):
        """Returns (logits (B, S, V) float32, aux_loss), with autograd.
        Under a mesh: the rank's rows and, where the vocab is split, its
        block of the vocab."""
        h, positions, offset = self._inputs_to_h(params, batch)
        h, aux = tfm.stack_apply(self.cfg, params["blocks"], h, positions,
                                 offset)
        return self._head(params, h, sequence_group(positions.shape[-1])), \
            aux

    def loss(self, params, batch):
        """batch {"tokens" (or "embeds"), "labels": (B, S) int} -> (total,
        {"ce",
        "z_loss", "aux"}), the reference's terms: labels < 0 are masked.
        The label's logit is gathered (the reference sums a one-hot
        select, which gives the same value).

        Under a mesh ``batch`` is the global batch and every rank returns
        the global loss: the cross-entropy's and the z-loss's numerators
        and the count of labels are summed over the batch group (so
        ranks with different numbers of masked labels give the global
        mean), and where the vocab is split the log-sum-exp and the
        label's logit are vocab-parallel (``_lse_and_label_logit``). The
        gradients follow the convention of
        ``parallel.collectives``."""
        logits, aux = self.train_logits(params, batch)
        labels = batch_block(batch["labels"]).long()
        lse, lab = _lse_and_label_logit(logits, labels)
        mask = (labels >= 0).to(torch.float32)
        batch_group = logical_group("batch")
        denom = torch.clamp_min(sum_detached(mask.sum(), batch_group), 1.0)
        ce = sum_over_batch(((lse - lab) * mask).sum(), batch_group) / denom
        # z-loss keeps the softmax normalizer bounded (MaxText-style)
        zl = 1e-4 * sum_over_batch((lse.square() * mask).sum(),
                                   batch_group) / denom
        total = ce + zl + 1e-2 * aux
        return total, {"ce": ce, "z_loss": zl, "aux": aux}

    # -- inference ---------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, params, batch) -> torch.Tensor:
        """Full-sequence forward: batch {"tokens": (B, S) int} or
        {"embeds": (B, S, d)} (optional "positions" (B, S) or (3, B, S))
        -> logits (B, S, V) float32. Under a mesh ``batch`` is the global
        batch and the params the rank's blocks: the rank's rows and, where
        the vocab is split, its block of the logits (``gather_logits``
        makes them whole)."""
        h, positions, offset = self._inputs_to_h(params, batch)
        h, _ = tfm.stack_apply(self.cfg, params["blocks"], h, positions,
                               offset)
        return self._head(params, h, sequence_group(positions.shape[-1]))

    @torch.inference_mode()
    def cache_init(self, batch: int, max_len: int, dtype=None, device=None):
        """Zeroed caches (KV for attention sublayers, conv window and
        float32 state for mamba ones), stacked (n_groups, batch, ...) per
        leaf; under a mesh the rank's block of each leaf
        (``cache_specs``)."""
        dev = resolve_device(device)
        one = tfm.block_cache_init(self.cfg, batch, max_len, dtype,
                                   device=dev)
        return tree_map(
            lambda x: x.unsqueeze(0).repeat(self.cfg.n_groups,
                                            *([1] * x.dim())), one)

    def cache_specs(self):
        """``cache_init``'s tree with a spec tuple at every leaf."""
        return tfm.add_layers_axis(tfm.block_cache_specs(self.cfg))

    # -- deployment quantization (the int8 serve path) ---------------------
    @torch.no_grad()
    def quantize_params(self, params, bits: int = 8):
        """Every linear weight as int codes + per-output-channel scales
        (``layers.quantize_linear_params``), on the params' device, with
        the reference's ``visit`` rule: a dict whose ``"w"`` has ndim >= 2
        (>= 3 inside ``blocks``, whose leaves carry the stacked
        ``n_groups`` axis: quantized group by group, so the scales stay
        per layer and output channel) is a linear; ``router`` is left
        alone, as are bare tensors (the MoE's expert weights, norms, the
        mamba conv and ``A_log`` / ``D``) and ``embed``; ``head`` is
        visited unstacked. Groups are quantized one at a time, so no
        float32 copy of a whole stacked leaf is made.

        Under a mesh ``params`` are the rank's blocks (``param_specs``)
        and so is the result (``parallel.sharding.quantized_specs``): a
        weight whose fan-in is split takes each channel's scale over the
        ranks that split it, so the codes and scales are the blocks of the
        whole tree's."""
        specs = self.param_specs() if active_mesh() is not None else None

        def qlin(p, spec, stacked):
            group = (None if spec is None
                     else spec_group(spec["w"][1 if stacked else 0]))
            if not stacked:
                return quantize_linear_params(p, bits, group)
            groups = [quantize_linear_params(
                {k: v[g] for k, v in p.items()}, bits, group)
                for g in range(p["w"].shape[0])]
            return {k: torch.stack([q[k] for q in groups]) for k in groups[0]}

        def visit(p, spec, stacked):
            if isinstance(p, dict) and "w" in p and p["w"].dim() >= (
                    3 if stacked else 2):
                return qlin(p, spec, stacked)
            if isinstance(p, dict):
                return {k: (v if k == "router" else visit(
                    v, None if spec is None else spec[k], stacked))
                    for k, v in p.items()}
            return p

        out = {}
        for k, v in params.items():
            sub = None if specs is None else specs[k]
            if k == "blocks":
                out[k] = visit(v, sub, True)
            elif k == "head":
                out[k] = visit(v, sub, False)
            else:
                out[k] = v
        return out

    @torch.inference_mode()
    def decode_step(self, params, caches, tokens_or_embeds, cur_index):
        """One token for every sequence in the batch.

        tokens (B, 1) int, or embeds (B, 1, d) for ``embed_inputs=False``;
        cur_index an int or a (B,) tensor of per-slot positions. Returns
        (logits (B, 1, V) float32, caches), the caches updated in place.
        Under a mesh the tokens (and a per-slot ``cur_index``) are the
        global batch, ``caches`` the rank's blocks (``cache_init``), and
        the logits the rank's rows and vocab block, as ``prefill``'s."""
        h = self._embed(params, batch_block(tokens_or_embeds))
        if isinstance(cur_index, torch.Tensor) and cur_index.dim() == 1:
            cur_index = batch_block(cur_index)
        h, caches = tfm.stack_decode(self.cfg, params["blocks"], caches, h,
                                     cur_index)
        return self._head(params, h), caches


def gather_logits(logits: torch.Tensor) -> torch.Tensor:
    """The whole logits (B, S, V) on every rank from the rank's rows and
    vocab block that ``prefill`` / ``decode_step`` / ``train_logits``
    return under the active mesh (every rank of the mesh calls it); the
    logits themselves without one."""
    if active_mesh() is None:
        return logits
    spec = logical_to_spec(("batch",) + (None,) * (logits.dim() - 2)
                           + ("vocab",))
    return gather_leaf(logits, spec)
