"""FIFO-model-driven autotuner for the streaming deployment path, on torch.

The port of ``repro.deploy.autotune``. It replaces the executor's
constants with a search that prices first and measures second:

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

Two search modes share the model half, as in the reference: **probe**
(the default; the measured refinements above) and **model**
(``REPRO_AUTOTUNE=model``): probe-free, the learned wave-cost predictor
(``repro_torch.costmodel``; its shipped artifact is fitted to a synthetic
bootstrap fleet, not to the card's times) prices every micro-batch
candidate and both dispatch modes from ``wave_features``, K2's row blocks
and K1's tiles stay pure models, no clock is read and no model runs, and
the config records ``source: "predicted"``.

The search, the cache and the config schema (v4) are the reference's,
and so is the probe order under a scripted probe (``probe=``: one call per
candidate), so under the same scripted probe both packages choose the same
micro-batch and dispatch. What differs:

  * **Measured decisions are interleaved.** Each measured choice (the
    top micro-batches, K1's default against tuned tile, megakernel against
    staged) gives every candidate one warm pass, then ``PAIR_ROUNDS``
    rounds of one streaming pass per candidate in turn, and compares the
    medians (``probe_interleaved``); each candidate's median and spread
    go to the config's audit trail. Timing each candidate in a block of
    its own let drift between the blocks decide.
  * **The block models.** The reference prices VMEM tiles on a TPU
    (``VMEM_BUDGET_BYTES``, ``DENSE_BLOCK_CANDIDATES``, ``TARGET_ROWS``, a
    tie-break toward the 128 x 128 MXU tile). K2 (``csrc/conv_threshold.cu``)
    runs one 8-warp block per (sample, row block, up to 64 channels; or
    several samples of a small image), which stages its input band,
    weights and banks in shared memory (``kernels.ops.conv_threshold_plan``)
    and multiplies 128 or 256 output pixels a pass on the int8 tensor
    cores; ``plan_block_h`` counts the serial passes of a block times the
    waves of blocks the card's 132 SMs take for the wave, with blocks
    resident per SM bounded by threads and shared memory; ties go to fewer
    streamed input bytes. K1
    (``csrc/threshold_matmul.cu``) is built for the tiles of
    ``kernels.ops.TMM_TILE_SIZES``, 4 to 16 warps each; ``plan_block_mn``
    prices the same two terms for a tile (waves of resident blocks, then
    each warp's serial mma steps over K), then the bytes the grid
    re-streams (the reference's formula), then the fewest masked
    outputs, then the distance to ``TMM_DEFAULT_TILE``.
  * **The platform key.** The reference keys caches on
    ``jax.default_backend()`` ("cpu" on a CPU); the port on itself and its
    device (``torch-cuda-<device name>``, ``torch-cpu``), so the two
    packages never read each other's cached configs.
  * **Model mode's features** read the port's planners (Hopper budgets),
    so on schedules the two planners plan differently its predictions, and
    then its picks, may differ from the reference's
    (``repro_torch.costmodel.features``).
  * ``slo_micro_batch`` (the serving stack's operating point) raises
    ``NotImplementedError`` until ``repro_torch.serve.slo`` is ported.

Knobs, as in the reference: ``REPRO_AUTOTUNE=off|probe|model`` (unknown
spellings raise), ``REPRO_AUTOTUNE_CACHE=dir`` (default
``.repro_autotune``), ``REPRO_AUTOTUNE_FORCE=1`` (ignore the cache),
``REPRO_COSTMODEL_ARTIFACT`` (the predictor artifact of model mode).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.bops import (conv_input_band_bytes,
                                   megakernel_traffic_bytes, schedule_cost,
                                   staged_traffic_bytes)
from repro_torch.costmodel.features import wave_features
from repro_torch.deploy.lower import (FusedConvThresholdStage,
                                      FusedThresholdStage, plan_megakernel)
from repro_torch.kernels.conv_threshold import same_pad_1d
from repro_torch.kernels.ops import (STAGE_SMEM_BYTES, TMM_DEFAULT_TILE,
                                    TMM_TILE_SIZES, conv_pass_pixels,
                                    conv_threshold_plan,
                                    threshold_matmul_plan)
from repro_torch.obs import timer as obs_timer
from repro_torch.obs.tracer import NULL_TRACER

CONFIG_VERSION = 4   # the reference's schema: v4 carries source and the
                     # block_mn probe audit trail (older caches re-search)

#: Candidate micro-batch sizes (powers of two; filtered to <= batch).
MICRO_CANDIDATES = (1, 2, 4, 8, 16, 32, 64)

#: The H100's streaming multiprocessors (NVIDIA H100 SXM data sheet).
H100_SMS = 132

#: Threads and shared memory of one H100 SM (2048 threads, 228 KB), and
#: the shared memory the runtime keeps for each resident block (1 KB).
SM_THREADS = 2048
SM_SMEM_BYTES = 233_472
BLOCK_RESERVED_SMEM = 1024

#: Threads of one K2 block (``NT`` in ``csrc/conv_threshold.cu``: 8 warps).
K2_THREADS = 256


#: K1's k tile (``BK`` in ``csrc/threshold_matmul.cu``): 64 code bytes, two
#: mma k-steps of 32.
K1_BK = 64

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
    source: str = "probed"            # "probed" | "predicted" provenance
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


def blocks_per_sm(threads: int, smem_bytes: int) -> int:
    """Blocks of ``threads`` threads and ``smem_bytes`` of dynamic shared
    memory one SM holds at once (threads, shared memory with the
    runtime's 1 KB per block, and the 32-block cap; registers are not
    modelled)."""
    return max(1, min(SM_THREADS // int(threads),
                      SM_SMEM_BYTES // (int(smem_bytes)
                                        + BLOCK_RESERVED_SMEM), 32))


def plan_block_h(geom, samples: int = 64,
                 n_steps: int = 255) -> Dict[str, object]:
    """K2's output-row block for one direct-conv stage on a wave of
    ``samples`` samples with banks of ``n_steps`` steps.

    A block of ``K2_THREADS`` threads covers one sample (or, for a whole
    image of fewer than 128 pixels, ``samples_per_block``), ``block_h``
    rows and up to 64 channels (``kernels.ops.conv_threshold_plan``, which
    also gives its shared memory); it multiplies ``conv_pass_pixels``
    output pixels per pass, so it runs ``passes`` passes, the last one
    partly masked. The grid of ``ceil(samples / samples_per_block) *
    ceil(out_h / block_h) * ceil(out_ch / block_n)`` blocks runs in
    ``waves`` of ``H100_SMS *
    blocks_per_sm`` resident blocks. The model minimises ``waves *
    passes``, the serial passes of a block slot: small blocks mask
    pixels, large ones leave SMs without blocks. Ties go to fewer input
    bytes (``conv_input_band_bytes``: halo rows are read once per
    block), then to the smaller block. Returns the choice and the scored
    candidates."""
    wp = geom.in_w
    if geom.padding == "SAME":
        wp += sum(same_pad_1d(geom.in_w, geom.out_w, geom.stride,
                              geom.kernel))
    rows = []
    for bh in block_h_candidates(geom.out_h):
        plan = conv_threshold_plan(geom.in_ch, geom.out_ch, geom.kernel,
                                   geom.stride, wp, geom.out_h, geom.out_w,
                                   bh, n_steps, samples=samples)
        g = plan["samples_per_block"]
        pixels = g * plan["block_h"] * geom.out_w
        pass_px = conv_pass_pixels(plan["block_n"])
        passes = -(-pixels // pass_px)
        blocks = (-(-max(int(samples), 1) // g)
                  * -(-geom.out_h // plan["block_h"])
                  * -(-geom.out_ch // plan["block_n"]))
        resident = blocks_per_sm(K2_THREADS, plan["smem_bytes"])
        waves = -(-blocks // (H100_SMS * resident))
        rows.append({"block_h": bh, "samples_per_block": g,
                     "pixels": pixels, "passes": passes,
                     "smem_bytes": plan["smem_bytes"],
                     "blocks_per_sm": resident, "blocks": blocks,
                     "waves": waves, "slot_passes": waves * passes,
                     "pixel_share": pixels / (passes * pass_px),
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

def k1_warps(block_m: int, block_n: int) -> Tuple[int, int]:
    """K1's warp grid for a tile (``Cfg`` in ``csrc/threshold_matmul.cu``):
    at least 2 x 2 warps, each 16 or 32 rows by 16 or 32 channels."""
    return max(2, int(block_m) // 32), max(2, int(block_n) // 32)


def k1_smem_bytes(block_m: int, block_n: int, n_steps: int = 255) -> int:
    """Dynamic shared memory of one K1 block: the code and weight tiles
    (``K1_BK`` bytes deep in 80-byte rows) and its channels' banks, whole
    or in chunks (``kernels.ops.threshold_matmul_plan``)."""
    return int(threshold_matmul_plan(block_m, block_n,
                                     n_steps)["smem_bytes"])


def plan_block_mn(in_dim: int, out_dim: int, n_steps: int = 255,
                  wave_rows: int = 64,
                  candidates: Sequence[int] = TMM_TILE_SIZES
                  ) -> Dict[str, object]:
    """K1's ``(block_m, block_n)`` for one fused dense stage on a wave of
    ``wave_rows`` rows.

    A tile's grid of ``ceil(M/bm) * ceil(N/bn)`` blocks runs in ``waves``
    of ``H100_SMS * blocks_per_sm`` resident blocks (threads from
    ``k1_warps``, shared memory from ``k1_smem_bytes``); each warp then
    issues ``warp_mma`` serial mma steps: ``ceil(K / K1_BK)`` k tiles of
    two 32-deep steps over its (bm / warps_m / 16) x (bn / warps_n / 8)
    fragment tiles. Small tiles fill the card and shorten each warp's
    chain; the model minimises ``waves * warp_mma``. Ties go to the
    bytes the grid re-streams, as the reference's formula counts them
    (each x row block read once per column block, each w column block and
    bank slice once per row block):

        ceil(N/bn) * M*K*4  +  ceil(M/bm) * K*N  +  ceil(M/bm) * N*S*4

    then to the fewest outputs the grid covers (masked edges), then to the
    tile nearest ``TMM_DEFAULT_TILE``. A tile fits when its shared memory
    is within the 227 KB of a block (every tile does: deep banks are
    streamed). Returns the choice and the scored candidates."""
    m_ref = max(int(wave_rows), 1)
    rows = []
    for bm in sorted({int(b) for b in candidates}):
        for bn in sorted({int(b) for b in candidates}):
            n_row = -(-m_ref // bm)
            n_col = -(-max(out_dim, 1) // bn)
            stream = (n_col * m_ref * in_dim * 4.0
                      + n_row * in_dim * out_dim * 1.0
                      + n_row * out_dim * n_steps * 4.0)
            wm, wn = k1_warps(bm, bn)
            threads = 32 * wm * wn
            smem = k1_smem_bytes(bm, bn, n_steps)
            resident = blocks_per_sm(threads, smem)
            waves = -(-(n_row * n_col) // (H100_SMS * resident))
            warp_mma = (-(-max(in_dim, 1) // K1_BK) * 2
                        * max(bm // wm // 16, 1) * max(bn // wn // 8, 1))
            fits = smem <= STAGE_SMEM_BYTES and threads <= 1024
            rows.append({"block_m": bm, "block_n": bn,
                         "stream_bytes": stream, "smem_bytes": smem,
                         "threads": threads, "blocks_per_sm": resident,
                         "waves": waves, "warp_mma": warp_mma,
                         "slot_mma": waves * warp_mma,
                         "covered_outputs": n_row * bm * n_col * bn,
                         "fits_smem": fits})
    fitting = [r for r in rows if r["fits_smem"]]
    if not fitting:
        raise ValueError(f"no K1 tile of {candidates} fits a block")
    best = min(fitting, key=lambda r: (
        r["slot_mma"], r["stream_bytes"], r["covered_outputs"],
        abs(r["block_m"] - TMM_DEFAULT_TILE[0])
        + abs(r["block_n"] - TMM_DEFAULT_TILE[1])))
    return {"block_m": int(best["block_m"]),
            "block_n": int(best["block_n"]),
            "stream_bytes": float(best["stream_bytes"]),
            "slot_mma": int(best["slot_mma"]),
            "candidates": rows}


def slo_micro_batch(cm, p99_budget_ms: float, **kwargs):
    """The serving router's latency-budgeted micro-batch. It prices waves
    with the serving stack's service model, which the port does not have
    yet."""
    raise NotImplementedError(
        "slo_micro_batch needs the serving stack's ServiceModel, which "
        "waits for repro_torch.serve.slo")


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


#: Rounds of a measured pair decision: one streaming pass per candidate
#: in each round, the candidates in turn.
PAIR_ROUNDS = 7


def probe_interleaved(cm, x, arms: Dict[str, tuple], tracer=None,
                      key: str = "") -> Dict[str, Dict[str, float]]:
    """Time competing candidates in turns, so that drift (clock ramp, a
    first-touch allocation) falls on all of them alike.

    ``arms`` maps a label to ``(micro_batch, setup)``; ``setup()`` (or
    None) puts ``cm`` into that candidate's configuration before each of
    its passes, outside the timed span. Each arm gets one warm pass, then
    ``PAIR_ROUNDS`` rounds of one synchronised ``streaming_compiled`` pass
    per arm (A, B, A, B, ...). Returns per label the median ms, the spread
    (max - min) ms and every pass's ms; each timed pass is a ``probe``
    span (cat ``autotune``) on ``tracer`` when it is enabled."""
    tr = tracer if tracer is not None else NULL_TRACER

    def one(label: str, rnd: int) -> float:
        mb, setup = arms[label]
        if setup is not None:
            setup()
        cm._sync()
        t0 = obs_timer.now()
        cm.streaming_compiled(x, micro_batch=mb)
        cm._sync()
        t1 = obs_timer.now()
        if tr.enabled and rnd >= 0:
            tr.add_span("probe", t0, t1, cat="autotune",
                        args={"key": key, "arm": label, "micro_batch": mb,
                              "round": rnd, "probe_ms": (t1 - t0) * 1e3})
        return (t1 - t0) * 1e3

    for label in arms:                     # build and warm each candidate
        one(label, -1)
    ms: Dict[str, List[float]] = {label: [] for label in arms}
    for rnd in range(PAIR_ROUNDS):
        for label in arms:
            ms[label].append(one(label, rnd))
    out = {}
    for label, vals in ms.items():
        srt = sorted(vals)
        out[label] = {"median_ms": srt[len(srt) // 2],
                      "spread_ms": srt[-1] - srt[0], "ms": vals}
    return out


def _probe_dispatch(cm, x, wave: int, probe: Optional[Callable], tr,
                    key: str, audit: Dict) -> Tuple[float, float]:
    """Seconds of a ``wave``-row streaming pass in megakernel and in staged
    dispatch: interleaved measured rounds, or one scripted ``probe`` call
    each. Writes the probes (and the rounds' spreads) into ``audit``;
    leaves ``cm``'s dispatch as it found it."""
    prev = cm.dispatch_state()
    try:
        if probe is None:
            # each mode planned once; the rounds switch between the
            # two plans without re-planning
            cm.set_megakernel(True, prev[1])
            mega = cm.dispatch_state()
            cm.set_megakernel(False, prev[1])
            staged = cm.dispatch_state()
            stats = probe_interleaved(
                cm, x, {"megakernel": (wave, lambda: cm.restore_dispatch(
                            mega)),
                        "staged": (wave, lambda: cm.restore_dispatch(
                            staged))},
                tracer=tr, key=key)
            t_mega = stats["megakernel"]["median_ms"] / 1e3
            t_staged = stats["staged"]["median_ms"] / 1e3
            audit["spread_ms"] = {k: v["spread_ms"]
                                  for k, v in stats.items()}
            audit["rounds"] = PAIR_ROUNDS
        else:
            cm.set_megakernel(True, prev[1])
            t_mega = float(probe(cm, x, wave))
            cm.set_megakernel(False, prev[1])
            t_staged = float(probe(cm, x, wave))
    finally:
        cm.restore_dispatch(prev)
    audit["probe_ms"] = {"megakernel": t_mega * 1e3,
                         "staged": t_staged * 1e3}
    return t_mega, t_staged


def autotune_model(cm, batch: int = 64,
                   candidates: Sequence[int] = MICRO_CANDIDATES,
                   topk: int = 3,
                   probe: Optional[Callable] = None,
                   sample: Optional[torch.Tensor] = None,
                   directory: Optional[str] = None,
                   force: Optional[bool] = None,
                   tracer=None,
                   mode: Optional[str] = None,
                   predictor=None) -> TunedConfig:
    """Search (or load from the cache) the TunedConfig of one compiled
    model.

    ``probe(cm, x, micro_batch) -> seconds`` replaces the measured
    probes; with a scripted probe the whole search is deterministic (the
    model half always is). ``batch`` is the Offline pool the FIFO model
    prices. ``mode`` None follows ``REPRO_AUTOTUNE`` ("off" read as
    "probe": a direct call wants a search); "model" searches probe-free
    with ``predictor`` (default: the shipped artifact,
    ``repro_torch.costmodel.load_default``) and never calls ``probe``.
    Each measured probe is a ``probe`` span (cat ``autotune``) on the
    tracer (``tracer=``, else the model's)."""
    tr = tracer if tracer is not None else getattr(cm, "tracer", NULL_TRACER)
    if mode is None:
        mode = autotune_mode()
        if mode == "off":
            mode = "probe"
    if mode not in ("probe", "model"):
        raise ValueError(f"autotune mode {mode!r}: expected probe|model")
    if mode == "model" and predictor is None:
        from repro_torch.costmodel.model import load_default

        predictor = load_default()
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

    seed_stage_ms = None
    probe_ms: Dict[str, float] = {}
    x = None if mode == "model" else (
        default_sample(cm, batch) if sample is None else sample)
    if mode == "model":
        # -- probe-free: the predictor prices every candidate -------------
        # (the pool drains in n_micro waves of the predicted wave time)
        for cand in modeled:
            wave_ms = float(predictor.predict_ms(
                wave_features(cm, cand["micro_batch"])))
            cand["predicted_wave_ms"] = wave_ms
            cand["predicted_total_ms"] = wave_ms * cand["n_micro"]
        top = [min(modeled, key=lambda d: (d["predicted_total_ms"],
                                           d["micro_batch"]))]
    elif probe is None:
        # -- measured refinement on the top candidates -------------------
        # (the candidates timed in turns, PAIR_ROUNDS rounds, the median
        # of each; a scripted probe: one call per candidate, rank order)
        # stage_latencies seeds the refinement: the per-stage service
        # times it measured are kept in the config's audit trail
        seed_stage_ms = cm.stage_latencies(x[:min(batch, 8)])
        stats = probe_interleaved(
            cm, x, {str(c["micro_batch"]): (c["micro_batch"], None)
                    for c in top}, tracer=tr, key=key)
        for cand in top:
            st = stats[str(cand["micro_batch"])]
            cand["probe_ms"] = probe_ms[str(cand["micro_batch"])] = \
                st["median_ms"]
            cand["probe_spread_ms"] = st["spread_ms"]
            cand["probe_rounds"] = len(st["ms"])
    else:
        for cand in top:
            mb = cand["micro_batch"]
            t0 = obs_timer.now() if tr.enabled else 0.0
            t = float(probe(cm, x, mb))
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
            plan = plan_block_h(s.geom, samples=wave,
                                n_steps=int(s.stage.thresholds.shape[1]))
            block_h[s.name] = plan["block_h"]
            block_h_model[s.name] = plan
        elif isinstance(s, FusedThresholdStage):
            plan = plan_block_mn(s.in_dim, s.out_dim,
                                 n_steps=int(s.stage.thresholds.shape[1]),
                                 wave_rows=wave)
            block_mn[s.name] = [plan["block_m"], plan["block_n"]]
            block_mn_model[s.name] = plan

    # -- K1 tiles: measured refinement at the winning wave ----------------
    # (the model ranks, one probe pair decides, ties keep the model's pick;
    # measured probes time no pair when the model's tiles are the ones the
    # stages run already: the two arms would be one configuration)
    block_mn_probe: Dict = {}
    saved = {s.name: (s.block_m, s.block_n) for s in cm.schedule.stages
             if isinstance(s, FusedThresholdStage)}
    same = all(tuple(block_mn[n]) == (
        TMM_DEFAULT_TILE[0] if saved[n][0] is None else saved[n][0],
        TMM_DEFAULT_TILE[1] if saved[n][1] is None else saved[n][1])
        for n in block_mn)
    if mode == "probe" and block_mn and probe is None and same:
        block_mn_probe = {"wave_rows": wave, "n_micro": -(-batch // wave),
                          "pick": "tuned", "untimed": "model tiles are the "
                          "stages' own"}
    elif mode == "probe" and block_mn:

        def use_tiles(tuned: bool) -> None:
            for s in cm.schedule.stages:
                if isinstance(s, FusedThresholdStage):
                    s.block_m, s.block_n = (
                        block_mn[s.name] if tuned and s.name in block_mn
                        else saved[s.name])

        spread: Dict[str, float] = {}
        try:
            if probe is None:
                stats = probe_interleaved(
                    cm, x, {"default": (wave, lambda: use_tiles(False)),
                            "tuned": (wave, lambda: use_tiles(True))},
                    tracer=tr, key=key)
                t_default = stats["default"]["median_ms"] / 1e3
                t_tuned = stats["tuned"]["median_ms"] / 1e3
                spread = {k: v["spread_ms"] for k, v in stats.items()}
            else:
                t_default = float(probe(cm, x, wave))
                use_tiles(True)
                t_tuned = float(probe(cm, x, wave))
        finally:
            use_tiles(False)
        pick = "tuned" if t_tuned <= t_default else "default"
        block_mn_probe = {"wave_rows": wave, "n_micro": -(-batch // wave),
                          "probe_ms": {"tuned": t_tuned * 1e3,
                                       "default": t_default * 1e3},
                          "pick": pick}
        if spread:
            block_mn_probe["spread_ms"] = spread
            block_mn_probe["rounds"] = PAIR_ROUNDS
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
        if mode == "model":
            p_mega = float(predictor.predict_ms(
                wave_features(cm, wave, "megakernel")))
            p_staged = float(predictor.predict_ms(
                wave_features(cm, wave, "staged")))
            segment_mode_model["predicted_ms"] = {"megakernel": p_mega,
                                                  "staged": p_staged}
            t_mega, t_staged = p_mega, p_staged
        else:
            t_mega, t_staged = _probe_dispatch(
                cm, x, wave, probe, tr, key, segment_mode_model)
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
        source="predicted" if mode == "model" else "probed",
    )
    save_config(cfg, directory)
    return cfg
