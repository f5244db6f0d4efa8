"""Fault-tolerant training loop: checkpoint/restart, straggler watchdog,
preemption safety, deterministic resume.

The port of ``repro.train.loop``:

  * **auto-resume**: on start, the loop restores the latest checkpoint if one
    exists, into the initial state's tensors in place (a compiled step,
    ``core.programs.StepProgram``, holds them); the data pipeline is a
    pure function of step, so resume is exact.
  * **preemption / crash**: checkpoints are atomic (checkpoint/), so a kill
    at any instant loses at most `ckpt_every` steps; an exception inside
    the loop saves the last finished step's state synchronously before it
    propagates. The optimizer updates the state in place, so an exception
    raised inside that update (``TornStateError``) propagates unsaved.
  * **straggler watchdog**: per-step wall time is tracked against a running
    median; `slow_factor`x outliers increment a straggler counter. After
    `max_consecutive_slow` consecutive slow steps the loop checkpoints and
    raises ``ElasticRestart``: the launcher builds the state again and
    resumes from the checkpoint (on one card, on the same device).
  * **fault hooks**: `step_hook(step)` lets tests inject latency or
    exceptions at precise steps to exercise every path.

A step's time ends with a synchronisation on its first metric tensor, so
the watchdog measures the card's work and not its enqueueing. The clock
is ``repro_torch.obs.timer`` unless ``time_fn`` is given.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import statistics
import tempfile
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpoint import CheckpointManager, latest_step
from repro_torch.core.pytree import leaves
from repro_torch.obs import timer as obs_timer
from repro_torch.parallel.sharding import active_mesh, mesh_group

log = logging.getLogger("repro_torch.train")


class TornStateError(RuntimeError):
    """An exception inside an in-place state update: the state is part old,
    part new, and the crash path must not save it."""


class ElasticRestart(RuntimeError):
    """Raised when the watchdog requests a restart; the launcher catches
    this, builds the state again and calls ``run_training`` again, which
    resumes from the checkpoint the loop wrote first."""


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    keep_n: int = 3
    log_every: int = 10
    slow_factor: float = 3.0
    max_consecutive_slow: int = 5
    watchdog_warmup: int = 10
    # floor on the reference step time: sub-millisecond steps (toy models,
    # tests) sit inside OS scheduler jitter, so comparing against their raw
    # median makes the watchdog fire on noise rather than stragglers
    watchdog_min_step_s: float = 0.05


@dataclasses.dataclass
class LoopResult:
    final_step: int
    metrics_history: List[Dict]
    resumed_from: Optional[int]
    straggler_events: int


def _block_until_ready(x: Any) -> None:
    """Wait for the card's work behind ``x`` (a tensor on the card)."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.current_stream(x.device).synchronize()


def _all_ranks_agree(flag: bool, specs) -> bool:
    """``flag`` or'ed over the ranks of the active mesh (a rank-local
    decision that every rank must take alike: the watchdog's restart)."""
    mesh = active_mesh()
    if specs is None or mesh is None or mesh.size() == 1:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32,
                     device=mesh.device_type)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh_group(mesh))
    return bool(t.item())


def _restore_into(state, restored):
    """``restored`` copied into ``state``'s tensors in place (a compiled
    step holds them as its graphs' buffers: they are the state, and a
    restore must not put other tensors in their stead); returns
    ``state``."""
    with torch.no_grad():
        for dst, src in zip(leaves(state), leaves(restored)):
            dst.copy_(src)
    return state


def run_training(
    train_step: Callable,
    init_state: Any,
    batch_fn: Callable[[int], Any],
    cfg: LoopConfig,
    step_hook: Optional[Callable[[int], None]] = None,
    time_fn: Optional[Callable[[], float]] = None,
    state_specs=None,
) -> LoopResult:
    """Run (or resume) training until cfg.total_steps. Under a mesh
    ``state_specs`` is the state's spec tree: checkpoints gather the
    rank's blocks and restores reshard them (``checkpoint``), and the
    watchdog's restart is taken by every rank of the mesh or by none."""
    if time_fn is None:
        time_fn = obs_timer.now   # injectable process-wide clock
    mgr = CheckpointManager(cfg.ckpt_dir, every=cfg.ckpt_every,
                            keep_n=cfg.keep_n, specs=state_specs)
    state = init_state
    start = 0
    resumed_from = None
    if latest_step(cfg.ckpt_dir) is not None:
        restored, start, _ = mgr.restore_latest(init_state)
        state = _restore_into(init_state, restored)
        resumed_from = start
        log.info("resumed from step %d", start)

    history: List[Dict] = []
    step_times: List[float] = []
    consecutive_slow = 0
    straggler_events = 0

    step = start
    try:
        while step < cfg.total_steps:
            t0 = time_fn()
            if step_hook is not None:
                step_hook(step)
            batch = batch_fn(step)
            state, metrics = train_step(state, batch)
            # block so the watchdog measures real step time
            _block_until_ready(next(iter(metrics.values())))
            dt = time_fn() - t0
            step += 1
            step_times.append(dt)

            if step % cfg.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"], m["step_time_s"] = step, dt
                history.append(m)
                log.info("step %d %s", step, m)

            # ---- straggler watchdog -----------------------------------
            if len(step_times) > cfg.watchdog_warmup:
                med = max(statistics.median(step_times[-50:]),
                          cfg.watchdog_min_step_s)
                if dt > cfg.slow_factor * med:
                    consecutive_slow += 1
                    straggler_events += 1
                    log.warning("slow step %d: %.3fs vs median %.3fs", step,
                                dt, med)
                else:
                    consecutive_slow = 0
                if _all_ranks_agree(
                        consecutive_slow >= cfg.max_consecutive_slow,
                        state_specs):
                    mgr.maybe_save(step, state, block=True, force=True)
                    raise ElasticRestart(
                        f"{consecutive_slow} consecutive straggler steps at "
                        f"{step}")

            mgr.maybe_save(step, state)
    except (ElasticRestart, TornStateError):
        raise
    except BaseException:
        # crash path: best-effort synchronous checkpoint, then re-raise
        try:
            mgr.maybe_save(step, state, block=True, force=True)
        except BaseException:  # pragma: no cover
            pass
        raise
    finally:
        mgr.wait()

    mgr.maybe_save(step, state, block=True, force=True)
    return LoopResult(
        final_step=step,
        metrics_history=history,
        resumed_from=resumed_from,
        straggler_events=straggler_events,
    )
