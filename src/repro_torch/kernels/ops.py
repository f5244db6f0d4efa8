"""Public wrappers around the port's CUDA kernels.

``threshold_matmul``, ``conv_threshold``, ``mlp_megakernel``,
``flash_attention``, ``multi_threshold`` and ``qmatmul`` are the
counterparts of the functions of the same names in ``repro.kernels.ops``.
Each one checks its arguments, then:

  * for CUDA tensors launches its kernel (``csrc/*.cu``, built at first
    use) on the current stream, or raises — there is no fallback;
  * for CPU tensors computes the same function with its plain version
    (``kernels.ref``); that is the path the CPU tests reach.

``launches`` counts kernel launches per kernel, and only those: the plain
versions do not count, so a run can show that it went through the
kernels (``reset_launches`` before, read after).
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
           "flash_attention", "multi_threshold", "qmatmul",
           "megakernel_smem_bytes", "plan_conv_blocks", "launches",
           "reset_launches", "FLASH_HEAD_DIMS", "TMM_TILE_SIZES",
           "TMM_DEFAULT_TILE", "multi_threshold_plan",
           "threshold_matmul_plan", "conv_threshold_plan", "search_steps",
           "conv_block_rows", "conv_block_pixels",
           "STAGE_SMEM_BYTES", "BANK_CHUNK_STEPS"]

#: Kernel launches since the last ``reset_launches``, by kernel name.
launches: Dict[str, int] = {"threshold_matmul": 0, "conv_threshold": 0,
                            "mlp_megakernel": 0, "flash_attention": 0,
                            "multi_threshold": 0, "qmatmul": 0}

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


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
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


def megakernel_smem_bytes(dims: Sequence[int]) -> int:
    """Shared memory of one ``mlp_megakernel`` block for the chain of
    widths ``dims`` (K_0, N_0, ..., N_last): the input row tile and up to
    two FIFO tiles of the widest intermediate width, int32, BM rows each.
    Never more than the planner's ``tile_bytes``, which also counts an
    output tile."""
    n_stages = len(dims) - 1
    inter = max(dims[1:-1], default=0)
    return 4 * MEGAKERNEL_BLOCK_M * (dims[0] + min(n_stages - 1, 2) * inter)


def mlp_megakernel(x_int: torch.Tensor, weights: Sequence[torch.Tensor],
                   banks: Sequence[torch.Tensor]) -> torch.Tensor:
    """A run of fused dense stages in one launch, inter-stage codes kept
    in shared memory.

    x_int (M, K_0) int32 codes; weights[d] (K_d, N_d) int8 with
    K_{d+1} = N_d; banks[d] (S_d, N_d) int32, step-major — the transpose
    of a stage's (N_d, S_d) ``thresholds``, so that the kernel reads one
    step of all channels at once (the executor transposes once per plan).
    Returns the last stage's (M, N_last) int32 codes. Ragged M needs no
    padding."""
    kind = _device_kind(x_int)
    _check(x_int, "x_int", torch.int32, 2, x_int.device)
    if len(weights) != len(banks) or not weights:
        raise ValueError(f"{len(weights)} weight matrices for {len(banks)} "
                         f"banks; need one of each per stage, at least one")
    if len(weights) > MEGAKERNEL_MAX_STAGES:
        raise ValueError(f"{len(weights)} stages; one launch takes at most "
                         f"{MEGAKERNEL_MAX_STAGES}")
    dims, steps = [x_int.shape[1]], []
    for d, (w, b) in enumerate(zip(weights, banks)):
        _check(w, f"weights[{d}]", torch.int8, 2, x_int.device)
        _check(b, f"banks[{d}]", torch.int32, 2, x_int.device)
        s, n = b.shape
        if w.shape != (dims[-1], n):
            raise ValueError(f"weights[{d}] shape {tuple(w.shape)} does not "
                             f"follow K={dims[-1]} and banks[{d}] "
                             f"{tuple(b.shape)}")
        dims.append(n)
        steps.append(s)
    smem = megakernel_smem_bytes(dims)
    if smem > MEGAKERNEL_SMEM_BYTES:
        raise ValueError(f"chain {dims} needs {smem} B of shared memory per "
                         f"block, above {MEGAKERNEL_SMEM_BYTES}")
    if kind == "cpu":
        return ref.mlp_megakernel_ref(x_int, weights, banks)
    m = x_int.shape[0]
    out = torch.empty((m, dims[-1]), dtype=torch.int32, device=x_int.device)
    if m == 0 or dims[-1] == 0:
        return out
    n_st = len(weights)
    w_ptrs = (ctypes.c_void_p * n_st)(*[w.data_ptr() for w in weights])
    t_ptrs = (ctypes.c_void_p * n_st)(*[b.data_ptr() for b in banks])
    c_dims = (ctypes.c_int * (n_st + 1))(*dims)
    c_steps = (ctypes.c_int * n_st)(*steps)
    fn = _build.entry_point("mlp_megakernel")
    err = fn(x_int.data_ptr(), out.data_ptr(), ctypes.addressof(w_ptrs),
             ctypes.addressof(t_ptrs), ctypes.addressof(c_dims),
             ctypes.addressof(c_steps), n_st, m,
             torch.cuda.current_stream(x_int.device).cuda_stream)
    _raise_on_error("mlp_megakernel", err)
    launches["mlp_megakernel"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """Flash attention with GQA, causal and sliding-window masks.

    q (B, H, Sq, D), k/v (B, Hkv, Sk, D), bfloat16 or float32, D in
    ``FLASH_HEAD_DIMS``; any strides with a contiguous last dimension (the
    model passes its (B, S, H, D) tensors transposed, without a copy).
    Query row i sits at position i + q_offset; keys at or beyond ``kv_len``
    (default Sk) are masked. Returns (B, H, Sq, D) in q's dtype and
    layout. Ragged Sq and Sk need no padding."""
    kind = _device_kind(q)
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
    if kind == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset, kv_len=kv_len)
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {FLASH_HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v need a contiguous last dimension")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} or heads {h} above the grid's 65535")
    if q.dtype == torch.bfloat16:
        # the tensor-core kernel reads q, k and v through TMA tensor maps:
        # bases and the strides of every dimension of extent > 1 must be
        # multiples of 16 bytes (8 elements)
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(
                    t.stride(i) % 8 for i in range(3) if t.shape[i] > 1):
                raise ValueError(f"bf16 {name} (strides {t.stride()}) needs "
                                 f"a 16-byte aligned base and strides")
    out = torch.empty_like(q)          # q's layout (contiguous if not dense)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *[t.stride(i) for t in (q, k, v, out) for i in range(3)])
    fn = _build.entry_point("flash_attention")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
             hkv, sq, sk, d, kv_len, int(causal), window, q_offset,
             int(q.dtype == torch.bfloat16), ctypes.addressof(strides),
             torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error("flash_attention", err)
    launches["flash_attention"] += 1
    return out


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


def qmatmul(x_int: torch.Tensor, w_int: torch.Tensor, scale: torch.Tensor,
            bias: Optional[torch.Tensor] = None, *, relu: bool = False,
            out_scale: Optional[float] = None) -> torch.Tensor:
    """Fused int8 stage: int8 x int8 into int32, times the per-channel
    ``scale``, plus ``bias``, optional ReLU, optional requant.

    x_int (M, K) int8, w_int (K, N) int8, scale and bias (N,) float32.
    Returns (M, N) float32, or int8 codes clip(round(y / out_scale)) when
    ``out_scale`` is set (the multiply by its float32 reciprocal, as the
    Pallas kernel does). Ragged M, N and K need no padding."""
    kind = _device_kind(x_int)
    _check(x_int, "x_int", torch.int8, 2, x_int.device)
    _check(w_int, "w_int", torch.int8, 2, x_int.device)
    _check(scale, "scale", torch.float32, 1, x_int.device)
    m, k = x_int.shape
    n = w_int.shape[1]
    if w_int.shape[0] != k or scale.shape[0] != n:
        raise ValueError(f"shapes x {tuple(x_int.shape)}, w "
                         f"{tuple(w_int.shape)}, scale {tuple(scale.shape)} "
                         f"do not chain")
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
                      dtype=torch.float32 if out_scale is None
                      else torch.int8)
    if out.numel() == 0:
        return out
    inv = 0.0 if out_scale is None else float(np.float32(1.0 / out_scale))
    fn = _build.entry_point("qmatmul")
    err = fn(x_int.data_ptr(), w_int.data_ptr(), scale.data_ptr(),
             None if bias is None else bias.data_ptr(), out.data_ptr(),
             m, n, k, int(relu), int(out_scale is not None), inv,
             torch.cuda.current_stream(x_int.device).cuda_stream)
    _raise_on_error("qmatmul", err)
    launches["qmatmul"] += 1
    return out
