"""Batched serving engine: continuous-batching prefill + decode slots.

The counterpart of ``repro.serving.engine.ServeEngine`` with the
reference's semantics:

  * a fixed decode batch of ``n_slots`` sequences;
  * a new request is prefilled alone, one token at a time through
    single-token ``decode_step``s into a batch-1 cache (exact KV), and that
    cache is written into a free slot;
  * every engine step decodes all slots with a per-slot ``cur_index``
    vector; finished sequences free their slot at once.

The engine runs on the card unless it is given ``device="cpu"``; asking for
the card without one raises. ``TinyModelServer`` comes with the serving
stack's slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.qir import resolve_device
from repro_torch.models.model import Model
from repro_torch.models.transformer import map_tree
from repro_torch.obs import timer as obs_timer


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # (P,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    submit_t: float = 0.0
    first_token_t: float = 0.0
    done_t: float = 0.0


class ServeEngine:
    def __init__(self, model: Model, params, n_slots: int = 4,
                 max_len: int = 256, device=None):
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params are on {table.device}, the engine on "
                             f"{self.device}")
        self.model = model
        self.cfg = model.cfg
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len

        self.caches = model.cache_init(n_slots, max_len, device=self.device)
        self.active: List[Optional[Request]] = [None] * n_slots
        self.positions = np.zeros(n_slots, np.int64)
        self.last_token = np.zeros((n_slots, 1), np.int32)
        self.queue: List[Request] = []
        self.finished: List[Request] = []

    # -- prefill one request into a slot via single-token steps (exact KV) --
    def _prefill_one(self, tokens: np.ndarray):
        """Tokens (P,) one decode step at a time into a batch-1 cache;
        returns (cache, logits (1, 1, V) of the last step)."""
        cache = self.model.cache_init(1, self.max_len, device=self.device)
        toks = torch.as_tensor(tokens, dtype=torch.int32, device=self.device)
        logits = None
        for i in range(toks.shape[0]):
            logits, cache = self.model.decode_step(self.params, cache,
                                                   toks[i].view(1, 1), i)
        return cache, logits

    def submit(self, req: Request):
        n = len(req.prompt)
        if n == 0 or (self.cfg.window == 0 and n > self.max_len):
            raise ValueError(f"request {req.uid}: prompt of {n} tokens; the "
                             f"engine takes 1..{self.max_len}")
        req.submit_t = obs_timer.now()
        self.queue.append(req)

    @torch.inference_mode()
    def _insert_into_slot(self, slot: int, req: Request):
        one_cache, last_logits = self._prefill_one(np.asarray(req.prompt))

        # caches are stacked (groups, batch, ...) trees: batch axis = 1
        def write_slot(batch_c, one_c):
            batch_c[:, slot] = one_c[:, 0].to(batch_c.dtype)

        map_tree(write_slot, self.caches, one_cache)
        tok = int(torch.argmax(last_logits.reshape(-1)))
        req.output.append(tok)
        req.first_token_t = obs_timer.now()
        self.active[slot] = req
        self.positions[slot] = len(req.prompt)
        self.last_token[slot, 0] = tok
        # the prefill-emitted token can already terminate the request
        self._maybe_finish(slot, tok)

    def _maybe_finish(self, slot: int, tok: int) -> bool:
        req = self.active[slot]
        done = (
            len(req.output) >= req.max_new_tokens
            or (req.eos_id is not None and tok == req.eos_id)
            or self.positions[slot] >= self.max_len - 1
        )
        if done:
            req.done_t = obs_timer.now()
            self.finished.append(req)
            self.active[slot] = None
        return done

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.active) if r is None]

    def step(self):
        """One engine iteration: admit from queue, then one decode step."""
        for slot in self._free_slots():
            if not self.queue:
                break
            self._insert_into_slot(slot, self.queue.pop(0))

        if not any(r is not None for r in self.active):
            return

        # per-slot positions: the decode step takes a (B,) cur_index vector,
        # so slots at different sequence lengths advance together.
        cur = torch.as_tensor(self.positions, dtype=torch.int32,
                              device=self.device)
        tokens = torch.as_tensor(self.last_token, device=self.device)
        logits, self.caches = self.model.decode_step(self.params, self.caches,
                                                     tokens, cur)
        next_tokens = torch.argmax(logits[:, 0], dim=-1).to(
            torch.int32).cpu().numpy()

        for i, req in enumerate(self.active):
            if req is None:
                continue
            tok = int(next_tokens[i])
            req.output.append(tok)
            self.positions[i] += 1
            self.last_token[i, 0] = tok
            self._maybe_finish(i, tok)

    def run_until_drained(self, max_steps: int = 10_000):
        steps = 0
        while (self.queue or any(r is not None for r in self.active)) \
                and steps < max_steps:
            self.step()
            steps += 1
        return steps

    # -- metrics -----------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        if not self.finished:
            return {}
        ttfts = [r.first_token_t - r.submit_t for r in self.finished]
        lats = [r.done_t - r.submit_t for r in self.finished]
        toks = sum(len(r.output) for r in self.finished)
        span = max(r.done_t for r in self.finished) - min(
            r.submit_t for r in self.finished
        )
        return {
            "n_requests": len(self.finished),
            "mean_ttft_s": float(np.mean(ttfts)),
            "mean_latency_s": float(np.mean(lats)),
            "throughput_tok_s": toks / max(span, 1e-9),
        }
