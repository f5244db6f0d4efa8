"""Public wrappers around the port's CUDA kernels.

``threshold_matmul``, ``conv_threshold``, ``mlp_megakernel``,
``flash_attention``, ``multi_threshold`` and ``qmatmul`` are the
counterparts of the functions of the same names in ``repro.kernels.ops``
(``flash_attention`` is differentiable: ``flash_attention_bwd`` is its
backward, a kernel of its own);
``float_head`` runs the deployed models' float head with a reduction
order that does not depend on the row count.
Each one checks its arguments, then:

  * for CUDA tensors launches its kernel (``csrc/*.cu``, built at first
    use) on the current stream, or raises — there is no fallback;
  * for CPU tensors computes the same function with its plain version
    (``kernels.ref``); that is the path the CPU tests reach.

``launches`` counts kernel launches per kernel, and only those: the plain
versions do not count, so a run can show that it went through the
kernels (``reset_launches`` before, read after). A replayed CUDA graph
(``core.programs``) launches its kernels without the wrappers; the
program adds the launches its capture recorded.

The wrappers can be captured into a CUDA graph: on the card a call reads
only shapes and Python values on the host (its plan), makes no host
sync, copies nothing from host memory and makes no tensor from Python
values; its kernel's library must be loaded before a capture (a
program's warm-up call loads it; ``_build.entry_point`` raises inside a
capture otherwise).

``qmatmul``, ``flash_attention`` and ``flash_attention_bwd`` also take
tensors on the ``meta`` device: they check their arguments and return
outputs of the shape, dtype and layout the kernel would write, and launch
nothing (the dry run, ``launch.dryrun``, traces the LM's steps there). The
other wrappers raise on meta tensors.

``kernel_observers`` see every wrapper call on every device, once, with
the kernel's name and its dimensions, before the call runs; while the call
runs ``inside_kernel()`` is true, so an op counter
(``launch.hlo_analysis``) counts the kernel by its own formula and skips
the ops inside it (the plain version on the CPU, the output's
allocation).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.bops import (MEGAKERNEL_BLOCK_M, MEGAKERNEL_MAX_STAGES,
                                   MEGAKERNEL_SMEM_BYTES)
from repro_torch.kernels import _build
from repro_torch.kernels import conv_threshold as _ct
from repro_torch.kernels import ref
from repro_torch.kernels.conv_threshold import plan_conv_blocks

__all__ = ["threshold_matmul", "conv_threshold", "mlp_megakernel",
           "flash_attention", "flash_attention_bwd", "multi_threshold",
           "qmatmul", "float_head",
           "megakernel_plan", "megakernel_layout",
           "megakernel_pack_weights", "megakernel_active_clusters",
           "plan_conv_blocks",
           "launches",
           "reset_launches", "FLASH_HEAD_DIMS", "TMM_TILE_SIZES",
           "TMM_DEFAULT_TILE", "multi_threshold_plan",
           "threshold_matmul_plan", "conv_threshold_plan", "search_steps",
           "conv_block_rows", "conv_block_pixels", "qmatmul_plan",
           "STAGE_SMEM_BYTES", "BANK_CHUNK_STEPS"]

#: Kernel launches since the last ``reset_launches``, by kernel name.
launches: Dict[str, int] = {"threshold_matmul": 0, "conv_threshold": 0,
                            "mlp_megakernel": 0, "flash_attention": 0,
                            "flash_attention_bwd": 0,
                            "multi_threshold": 0, "qmatmul": 0,
                            "float_head": 0}

#: ``threshold_matmul``'s output tiles: block_m and block_n each take one of
#: these (the template instantiations of ``csrc/threshold_matmul.cu``).
TMM_TILE_SIZES = (32, 64, 128)

#: The tile ``threshold_matmul`` takes unless a tuned config says otherwise:
#: the smallest, whose grid fills the card's 132 SMs best at the main
#: path's 1024-row stages (256 blocks for KWS, 96 for AD) and which timed
#: fastest there (PERF.md).
TMM_DEFAULT_TILE: Tuple[int, int] = (32, 32)

#: Head dims ``flash_attention``'s kernel is built for (16: the reduced
#: configs; 80: h2o-danube; 128: llama3, internlm2, qwen1.5).
FLASH_HEAD_DIMS = (16, 80, 128)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


#: Callables ``(kernel name, dims)`` told of every wrapper call
#: (``launch.hlo_analysis.OpCounter`` installs one while it counts).
kernel_observers: list = []
_inside = [0]


def inside_kernel() -> bool:
    """Whether a wrapper call is running (the ops it issues are its own)."""
    return _inside[0] > 0


def _observed(name: str, dims=None):
    """Tell ``kernel_observers`` of each call of the wrapped wrapper (its
    name and ``dims(*args, **kwargs)``) and mark the call's span for
    ``inside_kernel``; a call made inside another is not told again."""
    def deco(fn):
        @functools.wraps(fn)
        def wrap(*args, **kwargs):
            if not kernel_observers or _inside[0]:
                return fn(*args, **kwargs)
            d = dims(*args, **kwargs) if dims is not None else {}
            for observer in tuple(kernel_observers):
                observer(name, d)
            _inside[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                _inside[0] -= 1
        return wrap
    return deco


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _device_kind(x: torch.Tensor, meta: bool = False) -> str:
    """"cpu" or "cuda", or "meta" where the wrapper has a meta branch."""
    if x.device.type not in ("cpu", "cuda") and not (
            meta and x.device.type == "meta"):
        raise ValueError(f"no kernel or plain path for device {x.device}")
    return x.device.type


def _raise_on_error(kernel: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError_t {err}")


#: Shared memory a K1 or K2 block may take for its tiles, input band,
#: weights and banks: the 227 KB of a block less 1 KB for its static arrays
#: (``SMEM_DYN`` in ``csrc/threshold_epilogue.cuh``).
STAGE_SMEM_BYTES = 232_448 - 1024

#: Bank steps K1 and K2 stream through shared memory at a time when a
#: block's banks do not fit whole (``LINEAR_CHUNK``): then every bank is
#: counted step by step.
BANK_CHUNK_STEPS = 64

#: Bytes of one row of K1's shared-memory code and weight tiles: 64 k
#: bytes, padded to 80 so that the mma fragment loads avoid bank conflicts.
TMM_TILE_ROW_BYTES = 80

# launch flags of K1 and K2 (``FLAG_*`` in ``csrc/threshold_epilogue.cuh``)
_FLAG_SEARCH = 1    # whole banks in shared memory, sorted ones searched
_FLAG_CORES = 2     # dp4a products on the CUDA cores (timing variant)


def search_steps(s: int) -> int:
    """Steps of a whole bank of ``s`` steps in K1's and K2's shared memory:
    padded with INT32_MAX to 2^(floor(log2 s) + 1) - 1, so that every probe
    of their binary search is in range (``search_steps`` in
    ``csrc/threshold_epilogue.cuh``)."""
    s = int(s)
    return 0 if s <= 0 else 2 ** s.bit_length() - 1


@functools.lru_cache(maxsize=None)
def threshold_matmul_plan(block_m: int, block_n: int, s: int
                          ) -> Dict[str, object]:
    """How a ``threshold_matmul`` block of ``block_m`` x ``block_n``
    outputs holds a bank of ``s`` steps: ``search`` when the banks of its
    ``block_n`` channels fit shared memory whole beside the code and
    weight tiles and the accumulator tile (step-major, ``search_steps(s)
    * block_n`` int32), so sorted banks are searched and unsorted ones
    counted; otherwise they stream through it ``BANK_CHUNK_STEPS`` at a
    time and every bank is counted. ``smem_bytes`` is the block's dynamic
    shared memory either way. Cached (every launch asks for it): do not
    change the dict it returns."""
    bm, bn = int(block_m), int(block_n)
    tiles = (bm + bn) * TMM_TILE_ROW_BYTES + bm * (bn + 1) * 4
    whole = tiles + search_steps(s) * bn * 4
    search = whole <= STAGE_SMEM_BYTES
    return {"search": search,
            "smem_bytes": whole if search
            else tiles + BANK_CHUNK_STEPS * bn * 4}


def _tmm_launch(x_int: torch.Tensor, w_int: torch.Tensor,
                thresholds: torch.Tensor, block_m: int, block_n: int, *,
                linear: bool = False, cores: bool = False) -> torch.Tensor:
    """Launch K1 on checked, non-empty CUDA operands and return its
    output. ``linear`` streams the banks and counts every step even when
    they fit whole; ``cores`` multiplies on the CUDA cores (dp4a, the
    32 x 32 tile only): the two variants time the kernel's steps apart
    and give the same codes."""
    m, k = x_int.shape
    n, s = thresholds.shape
    plan = threshold_matmul_plan(block_m, block_n, s)
    flags = ((_FLAG_SEARCH if plan["search"] and not linear else 0)
             | (_FLAG_CORES if cores else 0))
    out = torch.empty((m, n), dtype=torch.int32, device=x_int.device)
    fn = _build.entry_point("threshold_matmul")
    err = fn(x_int.data_ptr(), w_int.data_ptr(), thresholds.data_ptr(),
             out.data_ptr(), m, n, k, s, block_m, block_n, flags,
             torch.cuda.current_stream(x_int.device).cuda_stream)
    _raise_on_error("threshold_matmul", err)
    return out


@_observed("threshold_matmul")
def threshold_matmul(x_int: torch.Tensor, w_int: torch.Tensor,
                     thresholds: torch.Tensor, *,
                     block_m: Optional[int] = None,
                     block_n: Optional[int] = None) -> torch.Tensor:
    """Fused integer dense stage (matmul + multi-threshold).

    x_int (M, K) int32 codes, w_int (K, N) int8, thresholds (N, S) int32
    (sorted or not: the count is the same); returns (M, N) int32 codes in
    [0, S]. Ragged shapes need no padding. ``block_m`` x ``block_n`` is
    the kernel's output tile, each in ``TMM_TILE_SIZES`` (None:
    ``TMM_DEFAULT_TILE``); every tile gives the same codes;
    ``threshold_matmul_plan`` says how its banks are held."""
    kind = _device_kind(x_int)
    bm = TMM_DEFAULT_TILE[0] if block_m is None else int(block_m)
    bn = TMM_DEFAULT_TILE[1] if block_n is None else int(block_n)
    if bm not in TMM_TILE_SIZES or bn not in TMM_TILE_SIZES:
        raise ValueError(f"tile {bm} x {bn}: block_m and block_n must be in "
                         f"{TMM_TILE_SIZES}")
    _check(x_int, "x_int", torch.int32, 2, x_int.device)
    _check(w_int, "w_int", torch.int8, 2, x_int.device)
    _check(thresholds, "thresholds", torch.int32, 2, x_int.device)
    m, k = x_int.shape
    n, s = thresholds.shape
    if w_int.shape != (k, n):
        raise ValueError(f"w_int shape {tuple(w_int.shape)} does not match "
                         f"x_int {tuple(x_int.shape)} and thresholds "
                         f"{tuple(thresholds.shape)}")
    if kind == "cpu":
        return ref.threshold_matmul_ref(x_int, w_int, thresholds)
    if m == 0 or n == 0:
        return torch.empty((m, n), dtype=torch.int32, device=x_int.device)
    if -(-n // bn) > 65535:
        raise ValueError(f"{n} channels: above the grid's 65535 x {bn}")
    out = _tmm_launch(x_int, w_int, thresholds, bm, bn)
    launches["threshold_matmul"] += 1
    return out


def _pixel_stride(c: int) -> int:
    """Bytes between two pixels of K2's staged input band: C rounded up to
    4 (the kernel zero-pads a pixel's channels to whole words of 4), and
    from 32 channels padded on to 16 mod 32 bytes, so that the fragment
    loads of 8 neighbouring pixels hit distinct banks."""
    words = -(-int(c) // 4)
    if words >= 8:
        while words % 8 != 4:
            words += 1
    return 4 * words


#: ``conv_threshold``'s channels per block (``block_n``): the least of these
#: at or above F, 64 above 32 (the kernel's template instantiations).
CONV_BLOCK_N = (8, 16, 32, 64)

#: A ``conv_threshold`` block that covers whole images takes up to this
#: many samples (``conv_threshold_plan``).
CONV_MAX_SAMPLES = 8


def conv_block_pixels(c: int, kernel: int) -> int:
    """Output pixels a ``conv_threshold`` block aims at for ``c`` input
    channels and a ``kernel`` x ``kernel`` conv: 8192 over its 32-deep k
    steps, within [256, 1024]. A block stages its channels' whole banks,
    its weights and its band once, so thin stages (a few k steps a pixel)
    want many pixels a block and deep ones more blocks
    (``bench/conv_block_sweep.py`` times the alternatives; PERF.md)."""
    steps = -(-int(kernel) * int(kernel) * (-(-int(c) // 4) * 4) // 32)
    return max(256, min(1024, 8192 // max(steps, 1)))


def conv_block_rows(out_h: int, out_w: int, c: int, kernel: int) -> int:
    """``conv_threshold``'s default output rows per block: about
    ``conv_block_pixels(c, kernel)`` pixels, at least 1 row, at most
    ``out_h``."""
    return max(1, min(int(out_h),
                      conv_block_pixels(c, kernel) // max(int(out_w), 1)))


def conv_pass_pixels(block_n: int) -> int:
    """Output pixels a ``conv_threshold`` block multiplies per pass
    (``Cfg::PASS`` in ``csrc/conv_threshold.cu``): 32 per warp, its 8 warps
    all along the pixels below 32 channels, 4 of them from 32."""
    return 256 if int(block_n) < 32 else 128


@functools.lru_cache(maxsize=None)
def conv_threshold_plan(c: int, f: int, kernel: int, stride: int, wp: int,
                        out_h: int, out_w: int, block_h: int, s: int,
                        samples: int = 1) -> Dict[str, object]:
    """How a ``conv_threshold`` block is laid out for input channels ``c``,
    output channels ``f``, a ``kernel`` x ``kernel`` conv at ``stride`` on
    padded rows ``wp`` wide, an ``out_h`` x ``out_w`` output, ``block_h``
    output rows per block, banks of ``s`` steps and a batch of
    ``samples``. A block covers ``block_n`` channels (``CONV_BLOCK_N``)
    and, when ``block_h`` covers the whole output of fewer pixels than
    ``conv_block_pixels``, ``samples_per_block`` samples (as many as that
    holds, at most ``CONV_MAX_SAMPLES``, fewer if they do not fit); it
    stages, in ``STAGE_SMEM_BYTES``: its input band (``band_rows`` rows of
    ``wp`` pixels, ``pixel_stride`` bytes each, per sample); its banks,
    whole (``search``: ``search_steps(s)`` steps of at least 32 slots)
    when they fit beside the band, one 32-deep weight chunk, a pass's
    output rows, band offsets and accumulator tile and the table of k's
    band offsets,
    else ``BANK_CHUNK_STEPS`` at a time with every bank counted; and its
    weights, ``k_chunk`` rows of the depth kernel*kernel*c (c padded to a
    multiple of 4) at a time, all of them when they fit. ``block_h`` is
    the one asked for unless the band does not fit; then samples per
    block, then ``block_h``, are halved until it does (every row block
    gives the same codes). Raises ValueError when one row's band does not
    fit. Cached (every launch asks for it): do not change the dict it
    returns."""
    c, f, kernel, stride = int(c), int(f), int(kernel), int(stride)
    block_n = next((b for b in CONV_BLOCK_N if b >= f), CONV_BLOCK_N[-1])
    slots = max(block_n, 32)
    pass_px = conv_pass_pixels(block_n)
    ps = _pixel_stride(c)
    k_full = -(-kernel * kernel * (-(-c // 4) * 4) // 32) * 32
    bh = max(1, min(int(block_h), int(out_h)))
    g = 1
    target = conv_block_pixels(c, kernel)
    if bh >= int(out_h) and 0 < int(out_h) * int(out_w) < target:
        g = max(1, min(int(samples), CONV_MAX_SAMPLES,
                       target // (int(out_h) * int(out_w))))
    # a pass's output rows, band offsets and accumulator tile, and the
    # table of k's band offsets (a word per 4 k)
    tile = pass_px * 12 + pass_px * (block_n + 1) * 4 + k_full
    while True:
        band = -(-g * _ct.band_rows(bh, stride, kernel) * int(wp) * ps
                 // 16) * 16
        w_min = block_n * (32 // 4 + 4) * 4
        search = (band + tile + search_steps(s) * slots * 4 + w_min
                  <= STAGE_SMEM_BYTES)
        bank = (search_steps(s) if search else BANK_CHUNK_STEPS) * slots * 4
        words = (STAGE_SMEM_BYTES - band - tile - bank) // (4 * block_n) - 4
        kc = min(k_full, 4 * words // 32 * 32)
        # more samples per block only while the weights still fit whole
        if kc >= 32 and (g == 1 or kc == k_full):
            break
        if g > 1:
            g //= 2
            continue
        if bh == 1:
            raise ValueError(f"conv_threshold: one output row's input band "
                             f"({_ct.band_rows(1, stride, kernel)} x {wp} "
                             f"pixels of {ps} bytes) does not fit "
                             f"{STAGE_SMEM_BYTES} bytes of shared memory")
        bh = max(1, bh // 2)
    return {"block_h": bh, "block_n": block_n, "pixel_stride": ps,
            "k_chunk": kc, "samples_per_block": g, "search": search,
            "smem_bytes": band + tile + bank + block_n * (kc // 4 + 4) * 4}


def _conv_launch(x_pad: torch.Tensor, w2d: torch.Tensor,
                 thresholds: torch.Tensor, *, kernel: int, stride: int,
                 out_h: int, out_w: int, block_h: int,
                 linear: bool = False, cores: bool = False) -> torch.Tensor:
    """Launch K2 on checked, padded, non-empty CUDA operands and return
    its output; ``linear`` and ``cores`` as in ``_tmm_launch``."""
    nb, hp, wp, c = x_pad.shape
    f, s = thresholds.shape
    plan = conv_threshold_plan(c, f, kernel, stride, wp, out_h, out_w,
                               block_h, s, samples=nb)
    flags = ((_FLAG_SEARCH if plan["search"] and not linear else 0)
             | (_FLAG_CORES if cores else 0))
    out = torch.empty((nb, out_h, out_w, f), dtype=torch.int32,
                      device=x_pad.device)
    fn = _build.entry_point("conv_threshold")
    err = fn(x_pad.data_ptr(), w2d.data_ptr(), thresholds.data_ptr(),
             out.data_ptr(), nb, hp, wp, c, f, kernel, stride, out_h, out_w,
             plan["block_h"], s, plan["block_n"], plan["pixel_stride"],
             plan["k_chunk"], plan["samples_per_block"], flags,
             torch.cuda.current_stream(x_pad.device).cuda_stream)
    _raise_on_error("conv_threshold", err)
    return out


@_observed("conv_threshold")
def conv_threshold(x_int: torch.Tensor, w2d: torch.Tensor,
                   thresholds: torch.Tensor, *, kernel: int, stride: int,
                   padding: str, out_h: int, out_w: int,
                   block_h: Optional[int] = None) -> torch.Tensor:
    """Fused direct-conv integer stage: NHWC codes -> threshold codes.

    x_int (N, H, W, C) int32, w2d (K*K*C, F) int8 in (kh, kw, c) order,
    thresholds (F, S) int32 (sorted or not). Pads on the host (the SAME
    split, ``conv_threshold.pad_input``); one thread block covers one
    sample, ``block_h`` output rows (None: ``conv_block_rows``; capped at
    ``out_h``) and up to 64 channels, laid out by ``conv_threshold_plan``;
    every row block gives the same codes. Returns (N, out_h, out_w, F)
    int32 codes."""
    kind = _device_kind(x_int)
    _check(x_int, "x_int", torch.int32, 4, x_int.device)
    _check(w2d, "w2d", torch.int8, 2, x_int.device)
    _check(thresholds, "thresholds", torch.int32, 2, x_int.device)
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    if block_h is not None and int(block_h) < 1:
        raise ValueError(f"block_h must be >= 1, got {block_h}")
    nb, _, _, c = x_int.shape
    f, s = thresholds.shape
    if w2d.shape != (kernel * kernel * c, f):
        raise ValueError(f"w2d shape {tuple(w2d.shape)} does not match "
                         f"kernel={kernel}, C={c}, F={f}")
    x_pad = _ct.pad_input(x_int, kernel=kernel, stride=stride,
                          padding=padding, out_h=out_h, out_w=out_w)
    hp, wp = x_pad.shape[1], x_pad.shape[2]
    if (hp < (out_h - 1) * stride + kernel
            or wp < (out_w - 1) * stride + kernel):
        raise ValueError(f"padded input {hp}x{wp} too small for "
                         f"out {out_h}x{out_w}, kernel={kernel}, "
                         f"stride={stride}")
    if kind == "cpu":
        return ref.conv_threshold_ref(x_pad, w2d, thresholds, kernel=kernel,
                                      stride=stride, out_h=out_h, out_w=out_w)
    if nb * out_h * out_w * f == 0:
        return torch.empty((nb, out_h, out_w, f), dtype=torch.int32,
                           device=x_int.device)
    bh = (conv_block_rows(out_h, out_w, c, kernel) if block_h is None
          else min(int(block_h), out_h))
    out = _conv_launch(x_pad, w2d, thresholds, kernel=kernel, stride=stride,
                       out_h=out_h, out_w=out_w, block_h=bh)
    launches["conv_threshold"] += 1
    return out


#: Threads of a ``mlp_megakernel`` CTA (``NT`` in
#: ``csrc/mlp_megakernel.cu``): 8 warps, which split a stage's products.
MEGAKERNEL_THREADS = 256

#: Largest cluster ``mlp_megakernel`` launches (``MAX_CLUSTER``): the
#: portable limit of 8 CTAs, so 8 x 227 KB of distributed shared memory.
MEGAKERNEL_MAX_CLUSTER = 8

#: Row tiles ``megakernel_plan`` picks from (``MAX_BLOCK_M`` is the
#: largest); admission prices ``core.bops.MEGAKERNEL_BLOCK_M``, the smallest.
MEGAKERNEL_ROW_TILES = (64, 32, 16, 8)

#: k per chunk when a CTA's weight slices do not fit its shared memory and
#: stream through it (``CHUNK_K``).
MEGAKERNEL_CHUNK_K = 128

# launch flags of K3 (``WEIGHTS_RESIDENT``, ``BANKS_RESIDENT`` in
# ``csrc/mlp_megakernel.cu``)
_MK_WEIGHTS_RESIDENT = 1
_MK_BANKS_RESIDENT = 2

#: Clusters of 1, 2, ..., 8 CTAs the H100 SXM runs at once:
#: ``cudaOccupancyMaxActiveClusters`` for ``mlp_megakernel`` (one CTA an SM,
#: which its registers allow; the same at every shared-memory size;
#: ``chip_smoke.py`` prints the card's beside it). A cluster lives in one
#: GPC, so large clusters leave SMs idle: 15 clusters of 8 use 120 of the
#: 132.
MEGAKERNEL_ACTIVE_CLUSTERS = (132, 66, 39, 30, 22, 17, 15, 15)


def _round_up(v: int, m: int) -> int:
    return -(-int(v) // m) * m


def _code_stride(width: int) -> int:
    """Words per row of K3's int32 code tiles (``code_stride``): at least
    the width rounded up to 8, and 16 mod 32, so that an A fragment's int4
    loads are free of bank conflicts."""
    r8 = _round_up(width, 8)
    return 16 if r8 <= 16 else 16 + _round_up(r8 - 16, 32)


def _weight_stride(nc: int) -> int:
    """Words per k-word row of a K3 CTA's staged weight slice of ``nc``
    channels (``weight_stride``): 8 mod 32, so that a B fragment's loads
    hit 32 distinct banks."""
    return _round_up(nc, 32) + 8


def _mk_tiles(n: int, cluster: int) -> int:
    """n8 tiles of a stage of ``n`` channels that one CTA of a cluster of
    ``cluster`` holds at most (CTA j: tiles [j T / C, (j + 1) T / C))."""
    return -(-(-(-int(n) // 8)) // int(cluster))


@functools.lru_cache(maxsize=None)
def megakernel_layout(dims: Tuple[int, ...], steps: Tuple[int, ...],
                      cluster: int, block_m: int, flags: int
                      ) -> Dict[str, int]:
    """Shared memory of one ``mlp_megakernel`` CTA, in bytes by part, for
    the chain of widths ``dims`` (K_0, N_0, ..., N_last) with banks of
    ``steps``, a cluster of ``cluster`` CTAs, a row tile of ``block_m`` rows
    and the residency ``flags`` (the arithmetic of ``layout`` in
    ``csrc/mlp_megakernel.cu``; every part is rounded up to 16 bytes):

      * ``codes``: the two int32 code tiles, ``block_m`` rows each, of the
        widest input of the even and of the odd stages (row strides
        ``_code_stride``);
      * ``acc``: the int32 accumulator tile, ``block_m`` rows of the most
        channels a CTA holds, rounded up to 32, plus 8;
      * ``weights``: resident, every stage's slice of the packed weights
        (``megakernel_pack_weights``), ``round_up(K, 32) / 4`` k words of
        ``_weight_stride`` words each; else one chunk of
        ``MEGAKERNEL_CHUNK_K / 4`` k words of the widest slice;
      * ``banks``: resident, every stage's slice step-major,
        ``search_steps(S)`` steps; else 0 (searched in global memory);
      * ``flags``: a falls bit per channel slot and stage, and the input's
        code-range vote.

    ``smem_bytes`` is their sum."""
    dims = tuple(int(d) for d in dims)
    n_st = len(steps)
    w0 = max(dims[d] for d in range(0, n_st, 2))
    w1 = max((dims[d] for d in range(1, n_st, 2)), default=0)
    nts = [_mk_tiles(n, cluster) for n in dims[1:]]
    r4 = lambda words: _round_up(words, 4)                       # noqa: E731
    codes = r4(block_m * _code_stride(w0)) + (
        r4(block_m * _code_stride(w1)) if n_st > 1 else 0)
    acc = r4(block_m * (_round_up(8 * max(nts), 32) + 8))
    if flags & _MK_WEIGHTS_RESIDENT:
        weights = sum(r4(_round_up(k, 32) // 4 * _weight_stride(8 * nt))
                      for nt, k in zip(nts, dims[:-1]))
    else:
        weights = r4(MEGAKERNEL_CHUNK_K // 4 * _weight_stride(8 * max(nts)))
    banks = (sum(r4(search_steps(s) * 8 * nt) for s, nt in zip(steps, nts))
             if flags & _MK_BANKS_RESIDENT else 0)
    flags_words = sum(r4(-(-8 * nt // 32)) for nt in nts) + r4(1)
    parts = {"codes": 4 * codes, "acc": 4 * acc, "weights": 4 * weights,
             "banks": 4 * banks, "flags": 4 * flags_words}
    parts["smem_bytes"] = sum(parts.values())
    return parts


def _mk_fit(dims, steps, cluster, block_m):
    """The first residency (weights and banks, weights, banks, neither)
    whose layout fits one CTA, as (flags, layout), or None."""
    for flags in (_MK_WEIGHTS_RESIDENT | _MK_BANKS_RESIDENT,
                  _MK_WEIGHTS_RESIDENT, _MK_BANKS_RESIDENT, 0):
        lay = megakernel_layout(dims, steps, cluster, block_m, flags)
        if lay["smem_bytes"] <= MEGAKERNEL_SMEM_BYTES:
            return flags, lay
    return None


def _mk_cost(dims, steps, m, cluster, block_m, flags, lay) -> float:
    """A launch's modelled time in SM cycles: waves of clusters
    (``MEGAKERNEL_ACTIVE_CLUSTERS`` at a time) times one CTA's chain — a
    fixed start, the bytes it stages (the row tile's input, its weight
    slices, its banks), and per stage a fixed cost, the longest warp's k
    steps (each an A fragment per m16 tile and an mma per tile), a weight
    chunk's two barriers when the weights stream, the epilogue's rounds (a
    search of bit_length(S) probes per item, in shared memory or, for banks
    that do not fit, in global memory; a store per peer) and the cluster
    barrier. The constants are fitted to ``bench/megakernel_sweep.py``'s
    512 timings (every cluster and row tile of KWS, AD and CNV's golden
    and full-width FC at 1, 16, 1024 and 4096 rows on an H100 SXM at
    700 W): its pick is within 3.2% of the fastest on all 16 there
    (PERF.md §6 gives the sweep)."""
    rows = min(int(block_m), int(m))
    waves = -(-(-(-int(m) // int(block_m)))
              // MEGAKERNEL_ACTIVE_CLUSTERS[int(cluster) - 1])
    mt = -(-rows // 16)
    staged = 4 * rows * dims[0] + lay["banks"] + sum(
        _round_up(k, 32) * 8 * _mk_tiles(n, cluster)
        for k, n in zip(dims[:-1], dims[1:]))
    chain = 1220.0 + staged / 24.4
    probe = 410.0 if flags & _MK_BANKS_RESIDENT else 1730.0
    for k, n, s in zip(dims[:-1], dims[1:], steps):
        nt = _mk_tiles(n, cluster)
        n_ks = -(-int(k) // 32)
        ng = -(-nt // 4)
        ksl = max(1, min(n_ks, 8 // max(ng, 1)))
        per_warp = -(-ng * ksl // 8) * -(-n_ks // ksl)
        chain += 5640 + per_warp * (11.6 + 87 * mt * min(4, nt))
        if not flags & _MK_WEIGHTS_RESIDENT:
            chain += -(-_round_up(k, 32) // MEGAKERNEL_CHUNK_K) * 1810
        items = rows * 2 * nt
        chain += -(-items // MEGAKERNEL_THREADS) * (
            probe * max(1, int(s).bit_length()) + 4.5 * cluster)
        chain += 116 if cluster > 1 else 0
    return waves * chain


@functools.lru_cache(maxsize=None)
def megakernel_plan(dims: Tuple[int, ...], steps: Tuple[int, ...],
                    m: Optional[int] = None, cluster: Optional[int] = None,
                    block_m: Optional[int] = None) -> Dict[str, object]:
    """How ``mlp_megakernel`` runs the chain of widths ``dims`` with banks
    of ``steps`` on ``m`` rows: the cluster size (CTAs, at most
    ``MEGAKERNEL_MAX_CLUSTER``), the row tile (``MEGAKERNEL_ROW_TILES``),
    whether the CTAs' weight and bank slices are resident in shared memory
    or streamed, and the per-CTA layout (``megakernel_layout``), with
    ``fits`` false when no choice fits 232,448 B.

    ``m`` None prices admission (``deploy.lower.plan_megakernel`` plans a
    segment without knowing its rows): the smallest row tile,
    ``core.bops.MEGAKERNEL_BLOCK_M``, at the largest cluster, whose slices
    are the smallest; a run admitted so fits at every M. Otherwise the row
    tile and the cluster minimise ``_mk_cost``: waves of clusters on the
    132 SMs times one CTA's chain; a batch-1 query runs one cluster of 8
    CTAs, a 1024-row wave clusters of 2 or 3 CTAs that fill the card in
    one wave.
    ``cluster`` and ``block_m`` pin either choice (the sweep,
    ``bench/megakernel_sweep.py``). Cached: do not change the dict it
    returns."""
    dims = tuple(int(d) for d in dims)
    steps = tuple(int(s) for s in steps)
    if m is None:
        cands = [(MEGAKERNEL_MAX_CLUSTER, MEGAKERNEL_BLOCK_M)]
    else:
        tiles = [b for b in MEGAKERNEL_ROW_TILES
                 if b == MEGAKERNEL_BLOCK_M or b < 2 * max(int(m), 1)]
        cands = [(c, b) for c in range(MEGAKERNEL_MAX_CLUSTER, 0, -1)
                 for b in tiles]
    if cluster is not None:
        cands = [(int(cluster), b) for b in
                 ((MEGAKERNEL_BLOCK_M,) if m is None else tiles)]
    if block_m is not None:
        cands = [(c, int(block_m)) for c in
                 sorted({c for c, _ in cands}, reverse=True)]
    best = None
    for c, b in cands:
        fit = _mk_fit(dims, steps, c, b)
        if fit is None:
            continue
        flags, lay = fit
        cost = 0.0 if m is None else _mk_cost(dims, steps, m, c, b, flags,
                                                lay)
        if best is None or cost < best[0]:
            best = (cost, c, b, flags, lay)
    if best is None:
        c = MEGAKERNEL_MAX_CLUSTER if cluster is None else int(cluster)
        b = MEGAKERNEL_BLOCK_M if block_m is None else int(block_m)
        lay = megakernel_layout(dims, steps, c, b, 0)
        return {"fits": False, "cluster": c, "block_m": b, "flags": 0,
                "weights_resident": False, "banks_resident": False,
                "smem_bytes": lay["smem_bytes"], "layout": lay}
    _, c, b, flags, lay = best
    return {"fits": True, "cluster": c, "block_m": b, "flags": flags,
            "weights_resident": bool(flags & _MK_WEIGHTS_RESIDENT),
            "banks_resident": bool(flags & _MK_BANKS_RESIDENT),
            "smem_bytes": lay["smem_bytes"], "layout": lay}


def megakernel_pack_weights(w_int: torch.Tensor) -> torch.Tensor:
    """A stage's (K, N) int8 weights as ``mlp_megakernel`` stages them:
    (ceil(K / 4), N) int32 words, word (q, n) holding w[4q .. 4q + 3, n]
    little-endian (zeros past K) — four k bytes of one channel, the B
    operand's word of ``mma.sync``, so that the kernel's copies land them
    in fragment order. The executor packs once per plan, as it transposes
    the banks."""
    k, n = w_int.shape
    kq = -(-k // 4)
    w = torch.zeros((4 * kq, n), dtype=torch.int8, device=w_int.device)
    w[:k] = w_int
    return w.reshape(kq, 4, n).permute(0, 2, 1).reshape(kq, 4 * n) \
        .view(torch.int32)


def _unpack_weights(wq: torch.Tensor, k: int) -> torch.Tensor:
    """The (K, N) int8 weights of ``megakernel_pack_weights``' words."""
    kq, n = wq.shape
    return wq.contiguous().view(torch.int8).reshape(kq, n, 4) \
        .permute(0, 2, 1).reshape(4 * kq, n)[:k].contiguous()


def megakernel_active_clusters(cluster: int, smem_bytes: int) -> int:
    """Clusters of ``cluster`` K3 CTAs of ``smem_bytes`` each that the
    current card runs at once (``cudaOccupancyMaxActiveClusters``, through
    ``mlp_megakernel_max_clusters`` of ``csrc/mlp_megakernel.cu``); needs
    the card. ``MEGAKERNEL_ACTIVE_CLUSTERS`` holds the H100's."""
    (lib,) = _build.build_all(["mlp_megakernel"])
    fn = ctypes.CDLL(str(lib)).mlp_megakernel_max_clusters
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    active = ctypes.c_int(0)
    _raise_on_error("mlp_megakernel_max_clusters",
                    fn(int(cluster), int(smem_bytes), ctypes.byref(active)))
    return active.value


def _mk_chain(x_int, weights, banks):
    """Checked (dims, steps) of a megakernel chain; each weights[d] is
    (K, N) int8 or its (ceil(K / 4), N) int32 packing."""
    _check(x_int, "x_int", torch.int32, 2, x_int.device)
    if len(weights) != len(banks) or not weights:
        raise ValueError(f"{len(weights)} weight matrices for {len(banks)} "
                         f"banks; need one of each per stage, at least one")
    if len(weights) > MEGAKERNEL_MAX_STAGES:
        raise ValueError(f"{len(weights)} stages; one launch takes at most "
                         f"{MEGAKERNEL_MAX_STAGES}")
    dims, steps = [x_int.shape[1]], []
    for d, (w, b) in enumerate(zip(weights, banks)):
        packed = w.dtype == torch.int32
        _check(w, f"weights[{d}]", torch.int32 if packed else torch.int8, 2,
               x_int.device)
        _check(b, f"banks[{d}]", torch.int32, 2, x_int.device)
        s, n = b.shape
        rows = -(-dims[-1] // 4) if packed else dims[-1]
        if w.shape != (rows, n):
            raise ValueError(f"weights[{d}] shape {tuple(w.shape)} does not "
                             f"follow K={dims[-1]} and banks[{d}] "
                             f"{tuple(b.shape)}"
                             + (" (packed: ceil(K / 4) rows)" if packed
                                else ""))
        dims.append(n)
        steps.append(s)
    return tuple(dims), tuple(steps)


def _mk_args(x_int, out, weights, banks, plan, dims, steps):
    """The C launcher's arguments (``csrc/mlp_megakernel.cu``) for one
    launch of ``plan``; the host arrays are kept alive with them."""
    n_st = len(weights)
    w_ptrs = (ctypes.c_void_p * n_st)(*[w.data_ptr() for w in weights])
    t_ptrs = (ctypes.c_void_p * n_st)(*[b.data_ptr() for b in banks])
    c_dims = (ctypes.c_int * (n_st + 1))(*dims)
    c_steps = (ctypes.c_int * n_st)(*steps)
    keep = (w_ptrs, t_ptrs, c_dims, c_steps)
    return keep, (x_int.data_ptr(), out.data_ptr(), ctypes.addressof(w_ptrs),
                  ctypes.addressof(t_ptrs), ctypes.addressof(c_dims),
                  ctypes.addressof(c_steps), n_st, x_int.shape[0],
                  plan["cluster"], plan["block_m"], plan["flags"],
                  plan["smem_bytes"])


@_observed("mlp_megakernel")
def mlp_megakernel(x_int: torch.Tensor, weights: Sequence[torch.Tensor],
                   banks: Sequence[torch.Tensor], *,
                   cluster: Optional[int] = None,
                   block_m: Optional[int] = None) -> torch.Tensor:
    """A run of fused dense stages in one launch, on thread-block clusters,
    inter-stage codes kept in distributed shared memory.

    x_int (M, K_0) int32 codes; weights[d] (K_d, N_d) int8 with
    K_{d+1} = N_d, or their ``megakernel_pack_weights`` words (int8 ones
    are packed here, on every call); banks[d] (S_d, N_d) int32,
    step-major — the transpose of a stage's (N_d, S_d) ``thresholds``
    (the executor packs and transposes once per plan). Returns the last
    stage's (M, N_last) int32 codes. Ragged M needs no padding. ``megakernel_plan`` picks the cluster size, the row
    tile and the residency (``cluster`` / ``block_m`` pin them; every
    choice gives the same codes); raises ValueError when no plan fits
    one CTA's shared memory, as the planner refuses such a run."""
    kind = _device_kind(x_int)
    dims, steps = _mk_chain(x_int, weights, banks)
    m = x_int.shape[0]
    plan = megakernel_plan(dims, steps, max(m, 1), cluster, block_m)
    if not plan["fits"]:
        raise ValueError(f"chain {list(dims)} (S {list(steps)}) needs "
                         f"{plan['smem_bytes']} B of shared memory per CTA "
                         f"at its smallest plan, above "
                         f"{MEGAKERNEL_SMEM_BYTES}")
    if kind == "cpu":
        return ref.mlp_megakernel_ref(
            x_int, [_unpack_weights(w, k) if w.dtype == torch.int32 else w
                    for w, k in zip(weights, dims)], banks)
    out = torch.empty((m, dims[-1]), dtype=torch.int32, device=x_int.device)
    if m == 0 or dims[-1] == 0:
        return out
    weights = [w if w.dtype == torch.int32 else megakernel_pack_weights(w)
               for w in weights]
    _keep, args = _mk_args(x_int, out, weights, banks, plan, dims, steps)
    fn = _build.entry_point("mlp_megakernel")
    err = fn(*args, torch.cuda.current_stream(x_int.device).cuda_stream)
    _raise_on_error("mlp_megakernel", err)
    launches["mlp_megakernel"] += 1
    return out


def _flash_check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: int, kv_len: Optional[int]) -> int:
    """Check K6's arguments; returns ``kv_len`` resolved."""
    _device_kind(q, meta=True)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be 4-D, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if k.shape != (b, hkv, sk, d) or v.shape != k.shape or h % hkv:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: need (B, H, Sq, D) and "
                         f"(B, Hkv, Sk, D) with Hkv dividing H")
    kv_len = sk if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= sk:
        raise ValueError(f"kv_len {kv_len} outside [0, {sk}]")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.device.type in ("cuda", "meta"):     # the kernel's own limits
        if d not in FLASH_HEAD_DIMS:
            raise ValueError(f"head dim {d} not in {FLASH_HEAD_DIMS}")
        if any(t.stride(-1) != 1 for t in (q, k, v)):
            raise ValueError("q, k, v need a contiguous last dimension")
        if b > 65535 or h > 65535:
            raise ValueError(f"batch {b} or heads {h} above the grid's "
                             f"65535")
    return kv_len


def _tma_ready(t: torch.Tensor) -> bool:
    """Whether the bf16 tensor-core kernels can read ``t`` through a TMA
    tensor map: a 16-byte aligned base and, for every dimension of extent
    > 1, a stride that is a multiple of 16 bytes (8 elements)."""
    return t.data_ptr() % 16 == 0 and not any(
        t.stride(i) % 8 for i in range(3) if t.shape[i] > 1)


def _check_tma(*named: torch.Tensor) -> None:
    for name, t in zip("qkv", named):
        if not _tma_ready(t):
            raise ValueError(f"bf16 {name} (strides {t.stride()}) needs "
                             f"a 16-byte aligned base and strides")


def _flash_dims(q, k, v, causal, window, q_offset, kv_len, want_lse=False):
    """K6's dimensions and mask, as ``kernel_observers`` get them."""
    b, h, sq, d = q.shape
    return {"b": b, "h": h, "hkv": k.shape[1], "sq": sq, "sk": k.shape[2],
            "d": d, "causal": bool(causal), "window": int(window),
            "q_offset": int(q_offset),
            "kv_len": k.shape[2] if kv_len is None else int(kv_len),
            "esize": q.element_size(), "lse": bool(want_lse)}


@_observed("flash_attention", _flash_dims)
def _flash_forward(q, k, v, causal: bool, window: int, q_offset: int,
                   kv_len: int, want_lse: bool):
    """K6's forward: (out, lse or None); lse (B, H, Sq) float32 only when
    ``want_lse`` (the backward needs it). On meta tensors: empty outputs
    in the kernel's layout, nothing launched."""
    if q.device.type == "meta":
        b, h, sq, _ = q.shape
        return torch.empty_like(q), (
            torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
            if want_lse else None)
    if q.device.type == "cpu":
        res = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset, kv_len=kv_len,
                                      return_lse=want_lse)
        return res if want_lse else (res, None)
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16:
        _check_tma(q, k, v)
    out = torch.empty_like(q)          # q's layout (contiguous if not dense)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if out.numel() == 0:
        if lse is not None:
            lse.fill_(float("inf"))
        return out, lse
    strides = (ctypes.c_longlong * 12)(
        *[t.stride(i) for t in (q, k, v, out) for i in range(3)])
    fn = _build.entry_point("flash_attention")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr() if lse is not None else None, b, h, hkv, sq, sk,
             d, kv_len, int(causal), window, q_offset,
             int(q.dtype == torch.bfloat16), ctypes.addressof(strides),
             torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error("flash_attention", err)
    launches["flash_attention"] += 1
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """K6 as a differentiable function: the forward kernel writes the
    per-row log-sum-exp beside its output, and the backward runs
    ``flash_attention_bwd`` (its kernel on CUDA tensors, the explicit
    formulas of ``ref.flash_attention_bwd_ref`` on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, kv_len):
        out, lse = _flash_forward(q, k, v, causal, window, q_offset, kv_len,
                                  want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = dict(causal=causal, window=window, q_offset=q_offset,
                        kv_len=kv_len)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, d_out,
                                         **ctx.mask)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """Flash attention with GQA, causal and sliding-window masks.

    q (B, H, Sq, D), k/v (B, Hkv, Sk, D), bfloat16 or float32, D in
    ``FLASH_HEAD_DIMS``; any strides with a contiguous last dimension (the
    model passes its (B, S, H, D) tensors transposed, without a copy).
    Query row i sits at position i + q_offset; keys at or beyond ``kv_len``
    (default Sk) are masked. Returns (B, H, Sq, D) in q's dtype and
    layout. Ragged Sq and Sk need no padding. Differentiable: when grad
    mode is on and q, k or v requires grad, the forward also keeps the
    log-sum-exp and the backward runs ``flash_attention_bwd``."""
    kv_len = _flash_check(q, k, v, window, kv_len)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window, q_offset,
                                     kv_len)
    return _flash_forward(q, k, v, causal, window, q_offset, kv_len,
                          want_lse=False)[0]


@_observed("flash_attention_bwd",
           lambda q, k, v, out, lse, d_out, *, causal=True, window=0,
           q_offset=0, kv_len=None: _flash_dims(q, k, v, causal, window,
                                               q_offset, kv_len))
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        d_out: torch.Tensor, *, causal: bool = True,
                        window: int = 0, q_offset: int = 0,
                        kv_len: Optional[int] = None):
    """K6's backward: (dq, dk, dv) of ``flash_attention`` from its inputs,
    its output ``out``, the forward's ``lse`` (B, H, Sq) float32 and the
    output's gradient ``d_out``. q, k and v take the forward's layouts
    (bf16: 16-byte aligned bases and strides, as the tensor-core kernels
    read them through TMA; the wrapper raises otherwise); ``out`` and
    ``d_out`` come in whatever layout autograd hands over and are copied
    when the kernels cannot read them as they are. dk and dv sum the query
    heads of a GQA group in a fixed order and no float atomics decide any
    result, so the gradients are the same on every run. Each comes back in
    its input's dtype and layout (on meta tensors: empty, nothing
    launched)."""
    kv_len = _flash_check(q, k, v, window, kv_len)
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    for name, t in (("out", out), ("d_out", d_out)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}; q is {q.dtype} {tuple(q.shape)}")
    if (lse.shape != (b, h, sq) or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError(f"lse must be ({b}, {h}, {sq}) float32 on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)}")
    mask = dict(causal=causal, window=window, q_offset=q_offset,
                kv_len=kv_len)
    if q.device.type == "meta":
        return tuple(torch.empty_like(t) for t in (q, k, v))
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, out, lse, d_out, **mask)
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        _check_tma(q, k, v)
    # out and d_out: a contiguous last dimension; in bf16 also the TMA
    # rules (d_out is read through a tensor map) and no zero strides; else
    # a fresh copy (``contiguous`` would keep a misaligned base)
    out, d_out = (
        t if t.stride(-1) == 1 and (not bf16 or _tma_ready(t) and all(
            t.stride(i) for i in range(3) if t.shape[i] > 1))
        else t.clone(memory_format=torch.contiguous_format)
        for t in (out, d_out))
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # the kernels' workspace: delta (B, H, Sq) in float32; in bf16 lse
    # log2(e) and delta, each (B, H, Sq rounded up to a multiple of 128)
    rows = b * h * (-(-sq // 128) * 128 if bf16 else sq)
    ws = torch.empty((2 * rows if bf16 else rows,), dtype=torch.float32,
                     device=q.device)
    strides = (ctypes.c_longlong * 24)(
        *[t.stride(i) for t in (q, k, v, out, d_out, dq, dk, dv)
          for i in range(3)])
    fn = _build.entry_point("flash_attention_bwd")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), d_out.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), ws.data_ptr(), b, h, hkv, sq, sk, d, kv_len,
             int(causal), window, q_offset, int(bf16),
             ctypes.addressof(strides),
             torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error("flash_attention_bwd", err)
    launches["flash_attention_bwd"] += 1
    return dq, dk, dv


#: Shared memory ``multi_threshold``'s search kernel may take for banks:
#: the 227 KB of a block less 1 KB for its static arrays.
MT_BANK_SMEM_BYTES = 232_448 - 1024


def multi_threshold_plan(c: int, s: int) -> int:
    """Channels per block of ``multi_threshold``'s search kernel, which
    stages whole banks step-major, ``s * (bc + 1)`` int32 words, and runs
    one row per thread: 4 for banks below 1024 steps, 1 for deeper ones (a
    block's staging grows with bc * s; the kernel is latency-bound, so
    small blocks that spread over the SMs win), never more than the next
    power of two at or above ``c``, halved until the banks fit
    ``MT_BANK_SMEM_BYTES``. 0 when not even one channel's bank fits: the
    chunked linear count."""
    bc = 4 if int(s) < 1024 else 1
    while bc > 1 and bc // 2 >= int(c):
        bc //= 2
    while bc >= 1 and int(s) * (bc + 1) * 4 > MT_BANK_SMEM_BYTES:
        bc //= 2
    return bc


@_observed("multi_threshold")
def multi_threshold(acc: torch.Tensor, thresholds: torch.Tensor
                    ) -> torch.Tensor:
    """Standalone FINN multi-threshold activation.

    acc (M, C) int32, thresholds (C, S) int32 (sorted or not: the count is
    the same); returns (M, C) int32 counts #(acc >= T[c, s]) in [0, S].
    Any bank depth, ragged M and C: the kernel pads nothing. It searches
    non-decreasing banks and counts the others step by step, channel by
    channel; ``multi_threshold_plan`` picks its block."""
    kind = _device_kind(acc)
    _check(acc, "acc", torch.int32, 2, acc.device)
    _check(thresholds, "thresholds", torch.int32, 2, acc.device)
    m, c = acc.shape
    if thresholds.shape[0] != c:
        raise ValueError(f"thresholds shape {tuple(thresholds.shape)} does "
                         f"not match acc {tuple(acc.shape)}")
    s = thresholds.shape[1]
    if kind == "cpu":
        return ref.multi_threshold_ref(acc, thresholds)
    out = torch.empty((m, c), dtype=torch.int32, device=acc.device)
    if out.numel() == 0:
        return out
    bc = multi_threshold_plan(c, s)
    if -(-c // (bc or 32)) > 65535:
        raise ValueError(f"{c} channels: above the grid's 65535 x "
                         f"{bc or 32}")
    fn = _build.entry_point("multi_threshold")
    err = fn(acc.data_ptr(), thresholds.data_ptr(), out.data_ptr(), m, c, s,
             bc, torch.cuda.current_stream(acc.device).cuda_stream)
    _raise_on_error("multi_threshold", err)
    launches["multi_threshold"] += 1
    return out


#: ``qmatmul``'s output tiles (``tile`` 0 and 1 of ``csrc/qmatmul.cu``):
#: 32 x 64 with 4 warps, 128 x 128 with 8 warps.
QMM_TILES = ((32, 64), (128, 128))

#: SMs of the H100 SXM: the large tile is taken only where its grid alone
#: fills them.
QMM_SMS = 132


def qmatmul_plan(m: int, k: int, n: int) -> Dict[str, object]:
    """``qmatmul``'s launch for an (m, k) x (k, n) product: the 128 x 128
    tile (8 warps of 64 x 32 mma tiles) when its grid has at least
    ``QMM_SMS`` blocks, else the 32 x 64 tile (4 warps of 16 x 32), whose
    grid at 512^3 is 128 blocks; ``cp_async`` when k is a multiple of 16,
    so the x tiles go to shared memory by 16-byte asynchronous copies (the
    kernel also needs x 16-byte aligned; otherwise byte loads)."""
    m, k, n = int(m), int(k), int(n)
    big = QMM_TILES[1]
    tile = 1 if -(-m // big[0]) * -(-n // big[1]) >= QMM_SMS else 0
    bm, bn = QMM_TILES[tile]
    return {"tile": tile, "block_m": bm, "block_n": bn,
            "blocks": -(-m // bm) * -(-n // bn), "cp_async": k % 16 == 0}


@_observed("qmatmul",
           lambda x_int, w_int, scale, bias=None, **kw: {
               "m": x_int.shape[0], "k": x_int.shape[1], "n": w_int.shape[1],
               "bias": bias is not None,
               "int8_out": kw.get("out_scale") is not None,
               "acc_out": scale is None})
def qmatmul(x_int: torch.Tensor, w_int: torch.Tensor,
            scale: Optional[torch.Tensor],
            bias: Optional[torch.Tensor] = None, *, relu: bool = False,
            out_scale: Optional[float] = None) -> torch.Tensor:
    """Fused int8 stage: int8 x int8 into int32, times the per-channel
    ``scale``, plus ``bias``, optional ReLU, optional requant.

    x_int (M, K) int8, w_int (K, N) int8, scale and bias (N,) float32.
    Returns (M, N) float32, or int8 codes clip(round(y / out_scale)) when
    ``out_scale`` is set (the multiply by its float32 reciprocal, as the
    Pallas kernel does). ``scale`` None: the accumulator mode, the (M, N)
    int32 sums themselves (no bias, ReLU or requant), which a mesh's
    row-parallel linear adds over its ranks before it rescales. Ragged M,
    N and K need no padding; ``qmatmul_plan`` picks the kernel's tile. On
    meta tensors: the empty output, nothing launched."""
    kind = _device_kind(x_int, meta=True)
    _check(x_int, "x_int", torch.int8, 2, x_int.device)
    _check(w_int, "w_int", torch.int8, 2, x_int.device)
    m, k = x_int.shape
    n = w_int.shape[1]
    acc_out = scale is None
    if acc_out:
        if bias is not None or relu or out_scale is not None:
            raise ValueError("the accumulator mode takes no bias, ReLU or "
                             "out_scale")
        if w_int.shape[0] != k:
            raise ValueError(f"shapes x {tuple(x_int.shape)}, w "
                             f"{tuple(w_int.shape)} do not chain")
    else:
        _check(scale, "scale", torch.float32, 1, x_int.device)
        if w_int.shape[0] != k or scale.shape[0] != n:
            raise ValueError(f"shapes x {tuple(x_int.shape)}, w "
                             f"{tuple(w_int.shape)}, scale "
                             f"{tuple(scale.shape)} do not chain")
    if bias is not None:
        _check(bias, "bias", torch.float32, 1, x_int.device)
        if bias.shape[0] != n:
            raise ValueError(f"bias shape {tuple(bias.shape)}, need ({n},)")
    if out_scale is not None and not float(out_scale) > 0:
        raise ValueError(f"out_scale must be > 0, got {out_scale}")
    if kind == "cpu":
        return ref.qmatmul_ref(x_int, w_int, scale, bias, relu=relu,
                               out_scale=out_scale)
    out = torch.empty((m, n), device=x_int.device,
                      dtype=torch.int32 if acc_out else
                      torch.float32 if out_scale is None else torch.int8)
    if kind == "meta" or out.numel() == 0:
        return out
    plan = qmatmul_plan(m, k, n)
    if -(-n // plan["block_n"]) > 65535:
        raise ValueError(f"{n} channels: above the grid's 65535 x "
                         f"{plan['block_n']}")
    inv = 0.0 if out_scale is None else float(np.float32(1.0 / out_scale))
    fn = _build.entry_point("qmatmul")
    err = fn(x_int.data_ptr(), w_int.data_ptr(),
             None if acc_out else scale.data_ptr(),
             None if bias is None else bias.data_ptr(), out.data_ptr(),
             m, n, k, int(relu), int(out_scale is not None), int(acc_out),
             inv, plan["tile"],
             torch.cuda.current_stream(x_int.device).cuda_stream)
    _raise_on_error("qmatmul", err)
    launches["qmatmul"] += 1
    return out


@_observed("float_head")
def float_head(x_int: torch.Tensor, w: torch.Tensor, in_scale: float,
               b: torch.Tensor) -> torch.Tensor:
    """The deployed float head: (x_int as float32 @ w) * in_scale + b.

    x_int (M, K) int32 codes, w (K, N) float32, b (N,) float32; returns
    (M, N) float32. The kernel sums each output's K products in an order
    fixed by K alone (splits of 16 or 32 consecutive k, each one FMA
    chain, added in split order), so a row's logits do not depend on how
    many rows come with it (cuBLAS picks its reduction by shape); then the
    rescale and the bias, each rounded on its own."""
    kind = _device_kind(x_int)
    _check(x_int, "x_int", torch.int32, 2, x_int.device)
    _check(w, "w", torch.float32, 2, x_int.device)
    _check(b, "b", torch.float32, 1, x_int.device)
    m, k = x_int.shape
    n = w.shape[1]
    if w.shape[0] != k or b.shape[0] != n:
        raise ValueError(f"shapes x {tuple(x_int.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)} do not "
                         f"chain")
    if kind == "cpu":
        return ref.float_head_ref(x_int, w, in_scale, b)
    out = torch.empty((m, n), dtype=torch.float32, device=x_int.device)
    if out.numel() == 0:
        return out
    fn = _build.entry_point("float_head")
    err = fn(x_int.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
             m, n, k, float(np.float32(in_scale)),
             torch.cuda.current_stream(x_int.device).cuda_stream)
    _raise_on_error("float_head", err)
    launches["float_head"] += 1
    return out
