"""FIFO-model-driven autotuner for the streaming deployment path, on torch.

The port of ``repro.deploy.autotune`` in its probe mode. It replaces the
executor's constants with a search that prices first and measures second:

  1. **Micro-batch** — every candidate is priced by the paper's FIFO pass
     (``CompiledTinyModel.plan_streaming``); the top few get measured
     ``streaming_compiled`` probes and the fastest probe wins.
  2. **K2's row block (block_h)** and **K1's tile (block_m, block_n)** —
     pure models in the kernels' own terms on the card (below), at the
     winning micro-batch, the wave the tuned kernels serve; the tile is
     then refined by one measured probe pair, as in the reference.
  3. **Segment dispatch (megakernel or staged)** — where the planner admits
     a megakernel run, the residency traffic model ranks the two modes and
     a probe of each at the winning micro-batch decides; ties go to the
     model's pick.

The search, the probe order, the cache and the config schema (v4) are the
reference's, so under the same scripted probe both packages choose the
same micro-batch and dispatch. What differs:

  * **The block models.** The reference prices VMEM tiles on a TPU
    (``VMEM_BUDGET_BYTES``, ``DENSE_BLOCK_CANDIDATES``, ``TARGET_ROWS``, a
    tie-break toward the 128 x 128 MXU tile). K2 (``csrc/conv_threshold.cu``)
    runs one 256-thread block per (sample, row block), its threads striding
    over the block's outputs, so ``plan_block_h`` counts the serial passes
    of a thread slot: the strides a block needs, times the waves of blocks
    the card's 132 SMs (8 resident blocks each) take for the wave; ties go
    to fewer streamed input bytes. K1 (``csrc/threshold_matmul.cu``) is
    built for the tiles of ``kernels.ops.TMM_TILE_SIZES``; ``plan_block_mn``
    prices the bytes its grid re-streams (the reference's formula), checks
    the tile's shared memory against the 227 KB a block may use, and
    breaks ties toward the fewest masked outputs and then the default
    64 x 64 tile.
  * **The platform key.** The reference keys caches on
    ``jax.default_backend()`` ("cpu" on a CPU); the port on itself and its
    device (``torch-cuda-<device name>``, ``torch-cpu``), so the two
    packages never read each other's cached configs.
  * **Model mode** (``REPRO_AUTOTUNE=model``, the learned cost model) and
    ``slo_micro_batch`` (the serving stack's operating point) raise
    ``NotImplementedError``: they come with ROADMAP queue 1 items 7 and 6.

Knobs, as in the reference: ``REPRO_AUTOTUNE=off|probe|model`` (unknown
spellings raise), ``REPRO_AUTOTUNE_CACHE=dir`` (default
``.repro_autotune``), ``REPRO_AUTOTUNE_FORCE=1`` (ignore the cache).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.core.bops import MEGAKERNEL_SMEM_BYTES as SMEM_PER_BLOCK
from repro_torch.core.bops import (conv_input_band_bytes,
                                   megakernel_traffic_bytes, schedule_cost,
                                   staged_traffic_bytes)
from repro_torch.deploy.lower import (FusedConvThresholdStage,
                                      FusedThresholdStage, plan_megakernel)
from repro_torch.kernels.ops import TMM_DEFAULT_TILE, TMM_TILE_SIZES
from repro_torch.obs import timer as obs_timer
from repro_torch.obs.tracer import NULL_TRACER

CONFIG_VERSION = 4   # the reference's schema: v4 carries source and the
                     # block_mn probe audit trail (older caches re-search)

#: Candidate micro-batch sizes (powers of two; filtered to <= batch).
MICRO_CANDIDATES = (1, 2, 4, 8, 16, 32, 64)

#: The H100's streaming multiprocessors (NVIDIA H100 SXM data sheet).
H100_SMS = 132

#: Threads of one K2 block (``THREADS`` in ``csrc/conv_threshold.cu``).
K2_THREADS = 256

#: K2 blocks resident on one SM: 2048 threads per SM over K2_THREADS.
K2_BLOCKS_PER_SM = 2048 // K2_THREADS

#: K1's shared-memory step along K (``BK`` in ``csrc/threshold_matmul.cu``).
K1_BK = 32

#: Spellings the tri-state accepts (the reference's); anything else raises.
_MODE_SPELLINGS = {
    "off": ("off", "0", "", "false", "no", "none", "disable", "disabled"),
    "probe": ("probe", "1", "on", "true", "yes", "probed", "measure"),
    "model": ("model", "predict", "predicted", "predictor"),
}


def autotune_mode() -> str:
    """Explicit tri-state from ``REPRO_AUTOTUNE``: off | probe | model.
    Unknown spellings are an error, never a silent default."""
    raw = os.environ.get("REPRO_AUTOTUNE", "probe").strip().lower()
    for mode, spellings in _MODE_SPELLINGS.items():
        if raw in spellings:
            return mode
    raise ValueError(f"REPRO_AUTOTUNE={raw!r}: expected off|probe|model "
                     "(see deploy.autotune docstring)")


def autotune_enabled() -> bool:
    return autotune_mode() != "off"


def autotune_force() -> bool:
    return os.environ.get("REPRO_AUTOTUNE_FORCE", "0") not in ("0", "")


def cache_dir() -> str:
    return os.environ.get("REPRO_AUTOTUNE_CACHE", ".repro_autotune")


@dataclasses.dataclass
class TunedConfig:
    """The autotuner's artifact for one (model, platform): the reference's
    schema v4. ``candidates`` is the audit trail: every micro-batch with the
    modeled FIFO numbers that ranked it and, where one ran, its probe."""

    key: str                          # schedule fingerprint
    platform: str                     # the port and its device
    micro_batch: int
    block_h: Dict[str, int]           # conv stage name -> K2 row block
    fifo_depths: List[int]            # depths at the winning micro-batch
    modeled_cycles: int               # FIFO-sim cycles at the winner
    modeled_traffic_bytes: float      # per-query schedule traffic (tuned)
    candidates: List[Dict] = dataclasses.field(default_factory=list)
    block_h_model: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    block_mn: Dict[str, List[int]] = dataclasses.field(default_factory=dict)
    block_mn_model: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    segment_mode: str = "staged"      # "megakernel" | "staged" dispatch
    segment_mode_model: Dict = dataclasses.field(default_factory=dict)
    block_mn_probe: Dict = dataclasses.field(default_factory=dict)
    seed_stage_ms: Optional[List[Dict]] = None   # stage_latencies seed
    probe_ms: Optional[Dict[str, float]] = None  # micro_batch -> median ms
    source: str = "probed"            # "probed" ("predicted": item 7)
    version: int = CONFIG_VERSION

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "TunedConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in fields}
        d["block_h"] = {str(k): int(v)
                        for k, v in (d.get("block_h") or {}).items()}
        d["block_mn"] = {str(k): [int(v[0]), int(v[1])]
                         for k, v in (d.get("block_mn") or {}).items()}
        return cls(**d)


def config_path(key: str, directory: Optional[str] = None) -> str:
    return os.path.join(directory or cache_dir(), f"{key}.json")


def save_config(cfg: TunedConfig, directory: Optional[str] = None) -> str:
    path = config_path(cfg.key, directory)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(cfg.to_dict(), f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def load_config(key: str, directory: Optional[str] = None
                ) -> Optional[TunedConfig]:
    path = config_path(key, directory)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        d = json.load(f)
    if d.get("version") != CONFIG_VERSION:
        return None   # stale schema: re-search
    return TunedConfig.from_dict(d)


def platform_key(device) -> str:
    """The port and its device, as a file-name-safe string:
    ``torch-cuda-<device name>`` or ``torch-cpu``."""
    device = torch.device(device)
    if device.type != "cuda":
        return f"torch-{device.type}"
    name = torch.cuda.get_device_name(device)
    return "torch-cuda-" + re.sub(r"[^A-Za-z0-9]+", "_", name).strip("_")


def schedule_key(cm) -> str:
    """Stable fingerprint of (model, platform, schedule shape): the cache
    identity, built as the reference's but on ``platform_key``."""
    platform = platform_key(cm.device)
    parts = [cm.schedule.meta.get("model", "model"), platform,
             f"{cm.schedule.in_scale:g}"]
    for s in cm.schedule.stages:
        part = (f"{type(s).__name__}:{s.name}:{s.in_dim}:{s.out_dim}:"
                f"{getattr(s, 'lowering', '')}")
        geom = getattr(s, "geom", None)
        if geom is not None:
            part += (f":k{geom.kernel}s{geom.stride}{geom.padding}"
                     f":{geom.in_h}x{geom.in_w}x{geom.in_ch}"
                     f"->{geom.out_h}x{geom.out_w}x{geom.out_ch}")
        parts.append(part)
    digest = hashlib.sha1("|".join(parts).encode()).hexdigest()[:10]
    return f"{cm.schedule.meta.get('model', 'model')}-{platform}-{digest}"


# ---------------------------------------------------------------------------
# K2's row block: pure model
# ---------------------------------------------------------------------------

def block_h_candidates(out_h: int) -> List[int]:
    cands = {1}
    b = 2
    while b < out_h:
        cands.add(b)
        b *= 2
    cands.add(out_h)
    return sorted(cands)


def plan_block_h(geom, samples: int = 64) -> Dict[str, object]:
    """K2's output-row block for one direct-conv stage on a wave of
    ``samples`` samples.

    A block of ``K2_THREADS`` threads covers one (sample, row block) and
    its threads stride over the block's ``block_h * out_w * out_ch``
    outputs: ``passes`` strides, the last one partly idle. The card holds
    ``H100_SMS * K2_BLOCKS_PER_SM`` blocks at once, so the grid of
    ``samples * ceil(out_h / block_h)`` blocks runs in ``waves``. The model
    minimises ``waves * passes``, the serial passes of one thread slot:
    small blocks idle threads, large ones leave SMs without blocks. Ties
    go to fewer input bytes (``conv_input_band_bytes``: halo rows are read
    once per block), then to the smaller block. Returns the choice and the
    scored candidates."""
    rows = []
    resident = H100_SMS * K2_BLOCKS_PER_SM
    for bh in block_h_candidates(geom.out_h):
        outputs = bh * geom.out_w * geom.out_ch
        passes = -(-outputs // K2_THREADS)
        blocks = max(int(samples), 1) * -(-geom.out_h // bh)
        waves = -(-blocks // resident)
        rows.append({"block_h": bh, "outputs": outputs, "passes": passes,
                     "blocks": blocks, "waves": waves,
                     "slot_passes": waves * passes,
                     "thread_share": outputs / (passes * K2_THREADS),
                     "input_bytes": conv_input_band_bytes(geom, bh)})
    best = min(rows, key=lambda r: (r["slot_passes"], r["input_bytes"],
                                    r["block_h"]))
    return {"block_h": int(best["block_h"]),
            "input_bytes": float(best["input_bytes"]),
            "slot_passes": int(best["slot_passes"]),
            "candidates": rows}


# ---------------------------------------------------------------------------
# K1's tile: pure model
# ---------------------------------------------------------------------------

def k1_smem_bytes(block_m: int, block_n: int) -> int:
    """Static shared memory of one K1 block: the k-major x tile (one
    padding column) and the w tile, int32, ``K1_BK`` deep."""
    return 4 * K1_BK * (block_m + 1) + 4 * K1_BK * block_n


def plan_block_mn(in_dim: int, out_dim: int, n_steps: int = 255,
                  wave_rows: int = 64,
                  candidates: Sequence[int] = TMM_TILE_SIZES
                  ) -> Dict[str, object]:
    """K1's ``(block_m, block_n)`` for one fused dense stage on a wave of
    ``wave_rows`` rows.

    K1's grid re-streams tiles as the reference's does: each x row block
    is read once per column block, each w column block and bank slice once
    per row block:

        ceil(N/bn) * M*K*4  +  ceil(M/bm) * K*N  +  ceil(M/bm) * N*S*4

    A tile fits when its shared memory (``k1_smem_bytes``) is within the
    227 KB of one block and it has at most 1024 threads (16 outputs each).
    Among fitting tiles the fewest streamed bytes win, then the fewest
    outputs the grid covers (masked edges), then the tile nearest the
    default ``TMM_DEFAULT_TILE``. Returns the choice and the scored
    candidates."""
    m_ref = max(int(wave_rows), 1)
    rows = []
    for bm in sorted({int(b) for b in candidates}):
        for bn in sorted({int(b) for b in candidates}):
            n_row = -(-m_ref // bm)
            n_col = -(-max(out_dim, 1) // bn)
            stream = (n_col * m_ref * in_dim * 4.0
                      + n_row * in_dim * out_dim * 1.0
                      + n_row * out_dim * n_steps * 4.0)
            smem = k1_smem_bytes(bm, bn)
            fits = smem <= SMEM_PER_BLOCK and bm * bn // 16 <= 1024
            rows.append({"block_m": bm, "block_n": bn,
                         "stream_bytes": stream, "smem_bytes": smem,
                         "covered_outputs": n_row * bm * n_col * bn,
                         "fits_smem": fits})
    fitting = [r for r in rows if r["fits_smem"]]
    if not fitting:
        raise ValueError(f"no K1 tile of {candidates} fits a block")
    best = min(fitting, key=lambda r: (
        r["stream_bytes"], r["covered_outputs"],
        abs(r["block_m"] - TMM_DEFAULT_TILE[0])
        + abs(r["block_n"] - TMM_DEFAULT_TILE[1])))
    return {"block_m": int(best["block_m"]),
            "block_n": int(best["block_n"]),
            "stream_bytes": float(best["stream_bytes"]),
            "candidates": rows}


def slo_micro_batch(cm, p99_budget_ms: float, **kwargs):
    """The serving router's latency-budgeted micro-batch. It prices waves
    with the serving stack's service model, which the port does not have
    yet."""
    raise NotImplementedError(
        "slo_micro_batch needs the serving stack's ServiceModel "
        "(repro_torch.serve.slo), ROADMAP queue 1 item 6")


# ---------------------------------------------------------------------------
# micro-batch: FIFO model first, measured refinement second
# ---------------------------------------------------------------------------

def default_sample(cm, batch: int) -> torch.Tensor:
    """A representative zero input batch shaped from the first stage, on
    the model's device."""
    s0 = cm.schedule.stages[0]
    if isinstance(s0, FusedConvThresholdStage):
        g = s0.geom
        shape = (batch, g.in_h, g.in_w, g.in_ch)
    else:
        shape = (batch, s0.in_dim)
    return torch.zeros(shape, dtype=torch.int32, device=cm.device)


def probe_streaming(cm, x, micro_batch: int, iters: int = 3,
                    runner: Optional[Callable] = None) -> float:
    """Median seconds of one streaming pass at a micro-batch size, each
    pass ending in a synchronise of the model's device. ``runner``
    defaults to ``cm.streaming_compiled``."""
    run = cm.streaming_compiled if runner is None else runner
    run(x, micro_batch=micro_batch)
    cm._sync()                     # build and warm
    times = []
    for _ in range(max(iters, 1)):
        t0 = obs_timer.now()
        run(x, micro_batch=micro_batch)
        cm._sync()
        times.append(obs_timer.now() - t0)
    times.sort()
    return times[len(times) // 2]


def autotune_model(cm, batch: int = 64,
                   candidates: Sequence[int] = MICRO_CANDIDATES,
                   topk: int = 3,
                   probe: Optional[Callable] = None,
                   sample: Optional[torch.Tensor] = None,
                   directory: Optional[str] = None,
                   force: Optional[bool] = None,
                   tracer=None,
                   mode: Optional[str] = None) -> TunedConfig:
    """Search (or load from the cache) the TunedConfig of one compiled
    model.

    ``probe(cm, x, micro_batch) -> seconds`` replaces the measured
    probes; with a scripted probe the whole search is deterministic (the
    model half always is). ``batch`` is the Offline pool the FIFO model
    prices. ``mode`` None follows ``REPRO_AUTOTUNE`` ("off" read as
    "probe": a direct call wants a search); "model" raises until the
    learned cost model is ported. Each measured probe is a ``probe`` span
    (cat ``autotune``) on the tracer (``tracer=``, else the model's)."""
    tr = tracer if tracer is not None else getattr(cm, "tracer", NULL_TRACER)
    if mode is None:
        mode = autotune_mode()
        if mode == "off":
            mode = "probe"
    if mode == "model":
        raise NotImplementedError(
            "autotune mode 'model' needs the learned cost model "
            "(repro_torch.costmodel), ROADMAP queue 1 item 7")
    if mode != "probe":
        raise ValueError(f"autotune mode {mode!r}: expected probe|model")
    key = schedule_key(cm)
    if not (autotune_force() if force is None else force):
        cached = load_config(key, directory)
        if cached is not None:
            return cached

    # -- micro-batch: rank every candidate by the FIFO model -------------
    mbs = sorted({int(m) for m in candidates if 1 <= int(m) <= batch})
    modeled = []
    for mb in mbs:
        n_micro = -(-batch // mb)
        depths, cycles = cm.plan_streaming(n_micro, micro_batch=mb)
        modeled.append({"micro_batch": mb, "n_micro": n_micro,
                        "modeled_cycles": cycles, "fifo_depths": depths})
    modeled.sort(key=lambda d: (d["modeled_cycles"], d["micro_batch"]))
    top = modeled[:max(1, topk)]

    # -- measured refinement on the top candidates -----------------------
    seed_stage_ms = None
    probe_ms: Dict[str, float] = {}
    x = default_sample(cm, batch) if sample is None else sample
    if probe is None:
        # stage_latencies seeds the refinement: a cheap service-time
        # estimate decides how many probe repetitions noise requires
        seed_stage_ms = cm.stage_latencies(x[:min(batch, 8)])
        service_ms = sum(s["ms"] for s in seed_stage_ms)
        iters = 5 if service_ms < 5.0 else (3 if service_ms < 50.0 else 1)

        def probe_fn(c, xx, mb):
            return probe_streaming(c, xx, mb, iters=iters)
    else:
        probe_fn = probe
    for cand in top:
        mb = cand["micro_batch"]
        t0 = obs_timer.now() if tr.enabled else 0.0
        t = float(probe_fn(cm, x, mb))
        probe_ms[str(mb)] = t * 1e3
        cand["probe_ms"] = t * 1e3
        if tr.enabled:
            tr.add_span("probe", t0, obs_timer.now(), cat="autotune",
                        args={"key": key, "micro_batch": mb,
                              "n_micro": cand["n_micro"],
                              "modeled_cycles": cand["modeled_cycles"],
                              "probe_ms": t * 1e3})
    winner = min(top, key=lambda d: (d.get("probe_ms", float("inf")),
                                     d["modeled_cycles"]))
    wave = int(winner["micro_batch"])
    if tr.enabled:
        tr.instant("autotune_winner", cat="autotune", key=key, mode=mode,
                   micro_batch=wave,
                   modeled_cycles=int(winner["modeled_cycles"]))

    # -- K2 row blocks and K1 tiles: pure models at the winning wave ------
    block_h: Dict[str, int] = {}
    block_h_model: Dict[str, Dict] = {}
    block_mn: Dict[str, List[int]] = {}
    block_mn_model: Dict[str, Dict] = {}
    for s in cm.schedule.stages:
        if isinstance(s, FusedConvThresholdStage) and s.lowering == "direct":
            plan = plan_block_h(s.geom, samples=wave)
            block_h[s.name] = plan["block_h"]
            block_h_model[s.name] = plan
        elif isinstance(s, FusedThresholdStage):
            plan = plan_block_mn(s.in_dim, s.out_dim,
                                 n_steps=int(s.stage.thresholds.shape[1]),
                                 wave_rows=wave)
            block_mn[s.name] = [plan["block_m"], plan["block_n"]]
            block_mn_model[s.name] = plan

    # -- K1 tiles: measured refinement at the winning wave ----------------
    # (the model ranks, one probe pair decides, ties keep the model's pick)
    block_mn_probe: Dict = {}
    if block_mn:
        saved = {s.name: (s.block_m, s.block_n) for s in cm.schedule.stages
                 if isinstance(s, FusedThresholdStage)}
        try:
            t_default = float(probe_fn(cm, x, wave))
            for s in cm.schedule.stages:
                if isinstance(s, FusedThresholdStage) and s.name in block_mn:
                    s.block_m, s.block_n = block_mn[s.name]
            t_tuned = float(probe_fn(cm, x, wave))
        finally:
            for s in cm.schedule.stages:
                if isinstance(s, FusedThresholdStage):
                    s.block_m, s.block_n = saved[s.name]
        pick = "tuned" if t_tuned <= t_default else "default"
        block_mn_probe = {"wave_rows": wave, "n_micro": -(-batch // wave),
                          "probe_ms": {"tuned": t_tuned * 1e3,
                                       "default": t_default * 1e3},
                          "pick": pick}
        if pick == "default":
            block_mn = {}
        if tr.enabled:
            tr.instant("block_mn_probe", cat="autotune", key=key,
                       pick=pick, tuned_ms=t_tuned * 1e3,
                       default_ms=t_default * 1e3)

    # -- segment dispatch: megakernel or staged ---------------------------
    segment_mode = "staged"
    segment_mode_model: Dict = {}
    plans = [p for p in (plan_megakernel(cm.schedule.stages, seg)
                         for seg in cm.segments) if p is not None]
    if plans:
        n_micro = -(-batch // wave)
        mega_b = staged_b = 0.0
        for p in plans:
            run = cm.schedule.stages[p.start:p.stop]
            mega_b += megakernel_traffic_bytes(run, n_micro * wave)
            staged_b += n_micro * staged_traffic_bytes(run, wave)
        segment_mode_model = {
            "wave_rows": wave, "n_micro": n_micro,
            "plans": [[p.start, p.stop] for p in plans],
            "megakernel_bytes": float(mega_b),
            "staged_bytes": float(staged_b),
            "bytes_saved": float(staged_b - mega_b),
        }
        model_pick = "megakernel" if mega_b <= staged_b else "staged"
        prev_mode, prev_budget = cm.megakernel, cm.megakernel_budget_bytes
        try:
            cm.set_megakernel(True, prev_budget)
            t_mega = float(probe_fn(cm, x, wave))
            cm.set_megakernel(False, prev_budget)
            t_staged = float(probe_fn(cm, x, wave))
        finally:
            cm.set_megakernel(prev_mode, prev_budget)
        segment_mode_model["probe_ms"] = {"megakernel": t_mega * 1e3,
                                          "staged": t_staged * 1e3}
        if t_mega < t_staged:
            segment_mode = "megakernel"
        elif t_mega == t_staged:
            segment_mode = model_pick
        segment_mode_model["model_pick"] = model_pick
        if tr.enabled:
            tr.instant("segment_mode", cat="autotune", key=key,
                       mode=segment_mode, model_pick=model_pick,
                       bytes_saved=float(staged_b - mega_b))

    # traffic of the tuned schedule (block_h applied)
    saved_h = {s.name: s.block_h for s in cm.schedule.stages
               if isinstance(s, FusedConvThresholdStage)}
    try:
        for s in cm.schedule.stages:
            if isinstance(s, FusedConvThresholdStage) and s.name in block_h:
                s.block_h = block_h[s.name]
        traffic = float(schedule_cost(cm.schedule.stages).traffic_bytes)
    finally:
        for s in cm.schedule.stages:
            if isinstance(s, FusedConvThresholdStage):
                s.block_h = saved_h[s.name]

    cfg = TunedConfig(
        key=key, platform=platform_key(cm.device),
        micro_batch=wave,
        block_h=block_h,
        fifo_depths=[int(d) for d in winner["fifo_depths"]],
        modeled_cycles=int(winner["modeled_cycles"]),
        modeled_traffic_bytes=traffic,
        candidates=modeled,
        block_h_model=block_h_model,
        block_mn=block_mn,
        block_mn_model=block_mn_model,
        segment_mode=segment_mode,
        segment_mode_model=segment_mode_model,
        block_mn_probe=block_mn_probe,
        seed_stage_ms=seed_stage_ms,
        probe_ms=probe_ms or None,
        source="probed",
    )
    save_config(cfg, directory)
    return cfg
