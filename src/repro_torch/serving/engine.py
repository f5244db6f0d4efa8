"""Batched serving engine: continuous-batching prefill + decode slots.

The counterpart of ``repro.serving.engine.ServeEngine`` with the
reference's semantics:

  * a fixed decode batch of ``n_slots`` sequences;
  * a new request is prefilled alone, one token at a time through
    single-token ``decode_step``s into a batch-1 cache (exact KV), and that
    cache is written into a free slot;
  * every engine step decodes all slots with a per-slot ``cur_index``
    vector; finished sequences free their slot at once.

On the card the decode step and the single-token prefill step are
compiled programs (``core.programs``): one CUDA graph each per engine
(its ``n_slots``, ``max_len`` and dtype), captured at the first call and
replayed, the reference's two jit programs. The decode graph takes the
tokens and the per-slot positions in its input buffers, updates the
engine's caches in place and ends in the argmax, so one ``.cpu()`` of
the next tokens is the step's only read; the prefill replays the batch-1
graph once a prompt token into one batch-1 cache the engine keeps, the
position a device tensor (the reference's ``lax.scan`` of decode steps,
without a program per prompt length). A step taken while a mesh is
active (``gloo``'s collectives cannot be captured) runs the same
functions eagerly (``Program.eager``). On the CPU they run eagerly.

Mamba sublayers' conv windows and states go into the slot as the KV
caches do, each leaf in the slot cache's dtype. Configs that take
embeddings (``embed_inputs=False``) are refused: the engine feeds token
ids, as the reference's does.

The engine runs on the card unless it is given ``device="cpu"``; asking for
the card without one raises.

``TinyModelServer`` serves the Table-1 tiny models concurrently: the port
of the reference's compatibility shim over the dynamic-batching router
(``repro_torch.serve``), one router lane per tenant, every batch a
``submit_wave`` wave.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.programs import Program
from repro_torch.core.pytree import leaves, tree_map
from repro_torch.core.qir import resolve_device
from repro_torch.models.model import Model
from repro_torch.obs import timer as obs_timer
from repro_torch.parallel.sharding import active_mesh


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
        if not model.cfg.embed_inputs:
            raise ValueError(f"{model.cfg.name} takes embeddings, not "
                             f"tokens (embed_inputs=False): the engine "
                             f"feeds token ids and has no frontend")
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
        #: the batch-1 cache every prefill steps into (zeroed first)
        self.one_cache = None
        self.decode_program = Program(self._decode_fn, self.device,
                                      "decode_step")
        self.prefill_program = Program(self._prefill_fn, self.device,
                                       "prefill_step")

    def _decode_fn(self, tokens, cur):
        """One decode step of every slot: (logits (n_slots, 1, V), the
        next tokens (n_slots,) int32); the caches are updated in place."""
        logits, _ = self.model.decode_step(self.params, self.caches, tokens,
                                           cur)
        return logits, torch.argmax(logits[:, 0], dim=-1).to(torch.int32)

    def _prefill_fn(self, token, cur):
        """One prompt token (1, 1) at position ``cur`` (a 0-d tensor) into
        the batch-1 cache: its logits (1, 1, V)."""
        logits, _ = self.model.decode_step(self.params, self.one_cache,
                                           token, cur)
        return logits

    @staticmethod
    def _run(program: Program):
        """The program, or its eager form while a mesh is active."""
        return program if active_mesh() is None else program.eager

    # -- prefill one request into a slot via single-token steps (exact KV) --
    @torch.inference_mode()
    def _prefill_one(self, tokens: np.ndarray):
        """Tokens (P,) one decode step at a time into the batch-1 cache;
        returns (cache, logits (1, 1, V) of the last step)."""
        if self.one_cache is None:
            self.one_cache = self.model.cache_init(1, self.max_len,
                                                   device=self.device)
        for leaf in leaves(self.one_cache):
            leaf.zero_()
        toks = torch.as_tensor(tokens, dtype=torch.int32, device=self.device)
        pos = torch.arange(toks.shape[0], dtype=torch.int32,
                           device=self.device)
        step = self._run(self.prefill_program)
        logits = None
        for i in range(toks.shape[0]):
            logits = step(toks[i].view(1, 1), pos[i])
        return self.one_cache, logits

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

        tree_map(write_slot, self.caches, one_cache)
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
        # so slots at different sequence lengths advance together; both
        # go from the host into the program's input buffers
        cur = torch.as_tensor(self.positions.astype(np.int32))
        tokens = torch.as_tensor(self.last_token)
        _, next_tokens = self._run(self.decode_program)(tokens, cur)
        next_tokens = next_tokens.cpu().numpy()

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


# ---------------------------------------------------------------------------
# multi-tenant tiny-model serving (repro_torch.deploy integration)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TinyRequest:
    """One inference request against a named tiny model."""

    uid: int
    model: str
    x: np.ndarray                        # (features...,) single sample
    submit_t: float = 0.0
    done_t: float = 0.0
    result: Optional[np.ndarray] = None


class _OfflineWaveAdapter:
    """Wave API for legacy tenants that only expose ``offline(batch)``.

    The router dispatches through ``submit_wave``; a tenant without one
    gets this adapter: no padding, the wave is just the batch (copied to
    the model's ``device``, the CPU when it names none), every row valid.
    """

    def __init__(self, model: Any):
        self.model = model
        self.default_micro_batch = 1

    def submit_wave(self, x, valid=None, micro_batch=None):
        y = self.model.offline(torch.as_tensor(
            np.asarray(x), device=getattr(self.model, "device", None)))
        n = np.asarray(x).shape[0]
        mask = np.ones(n, bool) if valid is None else np.asarray(valid, bool)
        return y, mask


class TinyModelServer:
    """All Table-1 tiny models served concurrently from one shared queue.

    A *compatibility shim* over the dynamic-batching router: the legacy
    API (``submit``/``step``/``run_until_drained``/``stats``), with every
    batch dispatched through the executor's segment waves
    (``CompiledTinyModel.submit_wave``) and one router lane per tenant so
    a burst on one model cannot starve the others. Tenants without a wave
    API still work through ``_OfflineWaveAdapter``. New code should use
    ``repro_torch.serve.Router`` directly (SLO admission, deadline
    batching, replica placement, sliding-window metrics live there).
    """

    def __init__(self, models: Dict[str, Any], max_batch: int = 32,
                 engine: Any = None):
        from repro_torch.serve import Router, RouterConfig

        self.models = dict(models)
        self.max_batch = max_batch
        self.queue: List[TinyRequest] = []
        self.finished: List[TinyRequest] = []
        self._uid = 0
        # explicitly-stepped router: waves of up to max_batch per tenant,
        # dispatched only from step() (legacy drain semantics, no deadline).
        # ``engine`` passes through to the router (e.g.
        # ``repro_torch.serve.AsyncEngine()`` to overlap tenants' waves
        # across a replica pool); step() reaps before reading results, so the
        # legacy submit/step/stats contract holds under either engine.
        self.router = Router(
            {name: (m if hasattr(m, "submit_wave")
                    else _OfflineWaveAdapter(m))
             for name, m in self.models.items()},
            RouterConfig(micro_batch=max_batch, auto_dispatch=False,
                         max_wait_ms=0.0),
            engine=engine)
        self._routed: Dict[int, Any] = {}   # TinyRequest.uid -> ServeRequest

    def submit(self, model: str, x: np.ndarray) -> TinyRequest:
        if model not in self.models:
            raise KeyError(f"unknown tiny model {model!r}; "
                           f"tenants: {sorted(self.models)}")
        req = TinyRequest(uid=self._uid, model=model, x=np.asarray(x),
                          submit_t=obs_timer.now())
        self._uid += 1
        self.queue.append(req)
        self._routed[req.uid] = self.router.submit(model, req.x,
                                                   arrival_t=req.submit_t)
        return req

    def step(self) -> int:
        """Run one wave per tenant; returns #requests served."""
        served = 0
        for name in self.models:
            served += self.router.dispatch_one(name, max_n=self.max_batch)
        # settle async in-flight waves before reading results back (a
        # no-op under the default blocking engine)
        self.router.reap(block=True)
        if served:
            still: List[TinyRequest] = []
            for req in self.queue:
                routed = self._routed[req.uid]
                if routed.result is not None:
                    req.result = np.asarray(routed.result)
                    req.done_t = routed.done_t
                    self.finished.append(req)
                    del self._routed[req.uid]
                else:
                    still.append(req)
            self.queue = still
        return served

    def run_until_drained(self, max_steps: int = 10_000) -> int:
        steps = 0
        while self.queue and steps < max_steps:
            self.step()
            steps += 1
        return steps

    def stats(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant and aggregate latency/throughput (legacy shape, plus
        the router's wave occupancy per tenant)."""
        if not self.finished:
            return {}
        out: Dict[str, Dict[str, float]] = {}
        span = (max(r.done_t for r in self.finished)
                - min(r.submit_t for r in self.finished))
        router_stats = self.router.stats()
        for name in self.models:
            lats = [r.done_t - r.submit_t for r in self.finished
                    if r.model == name]
            if not lats:
                continue
            out[name] = {
                "n": len(lats),
                "p50_ms": float(np.percentile(lats, 50) * 1e3),
                "p99_ms": float(np.percentile(lats, 99) * 1e3),
                "wave_occupancy":
                    router_stats[name]["metrics"].mean_occupancy,
            }
        out["_aggregate"] = {
            "n": len(self.finished),
            "throughput_qps": len(self.finished) / max(span, 1e-9),
        }
        return out
