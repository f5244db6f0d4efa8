"""Public wrappers around the port's CUDA kernels.

``threshold_matmul``, ``conv_threshold``, ``mlp_megakernel`` and
``flash_attention`` are the counterparts of the functions of the same names in ``repro.kernels.ops``.
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
from typing import Dict, Optional, Sequence

import torch

from repro_torch.core.bops import (MEGAKERNEL_BLOCK_M, MEGAKERNEL_MAX_STAGES,
                                   MEGAKERNEL_SMEM_BYTES)
from repro_torch.kernels import _build
from repro_torch.kernels import conv_threshold as _ct
from repro_torch.kernels import ref
from repro_torch.kernels.conv_threshold import plan_conv_blocks

__all__ = ["threshold_matmul", "conv_threshold", "mlp_megakernel",
           "flash_attention", "megakernel_smem_bytes", "plan_conv_blocks",
           "launches", "reset_launches", "FLASH_HEAD_DIMS"]

#: Kernel launches since the last ``reset_launches``, by kernel name.
launches: Dict[str, int] = {"threshold_matmul": 0, "conv_threshold": 0,
                            "mlp_megakernel": 0, "flash_attention": 0}

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


def threshold_matmul(x_int: torch.Tensor, w_int: torch.Tensor,
                     thresholds: torch.Tensor) -> torch.Tensor:
    """Fused integer dense stage (matmul + multi-threshold).

    x_int (M, K) int32 codes, w_int (K, N) int8, thresholds (N, S) int32;
    returns (M, N) int32 codes in [0, S]. Ragged shapes need no padding."""
    kind = _device_kind(x_int)
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
    out = torch.empty((m, n), dtype=torch.int32, device=x_int.device)
    if m == 0 or n == 0:
        return out
    fn = _build.entry_point("threshold_matmul")
    err = fn(x_int.data_ptr(), w_int.data_ptr(), thresholds.data_ptr(),
             out.data_ptr(), m, n, k, s,
             torch.cuda.current_stream(x_int.device).cuda_stream)
    _raise_on_error("threshold_matmul", err)
    launches["threshold_matmul"] += 1
    return out


def conv_threshold(x_int: torch.Tensor, w2d: torch.Tensor,
                   thresholds: torch.Tensor, *, kernel: int, stride: int,
                   padding: str, out_h: int, out_w: int) -> torch.Tensor:
    """Fused direct-conv integer stage: NHWC codes -> threshold codes.

    x_int (N, H, W, C) int32, w2d (K*K*C, F) int8 in (kh, kw, c) order,
    thresholds (F, S) int32. Pads on the host (the SAME split,
    ``conv_threshold.pad_input``); one thread block covers one sample and
    ``plan_conv_blocks`` output rows. Returns (N, out_h, out_w, F) int32
    codes."""
    kind = _device_kind(x_int)
    _check(x_int, "x_int", torch.int32, 4, x_int.device)
    _check(w2d, "w2d", torch.int8, 2, x_int.device)
    _check(thresholds, "thresholds", torch.int32, 2, x_int.device)
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
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
    out = torch.empty((nb, out_h, out_w, f), dtype=torch.int32,
                      device=x_int.device)
    if out.numel() == 0:
        return out
    fn = _build.entry_point("conv_threshold")
    err = fn(x_pad.data_ptr(), w2d.data_ptr(), thresholds.data_ptr(),
             out.data_ptr(), nb, hp, wp, c, f, kernel, stride, out_h, out_w,
             plan_conv_blocks(out_h, out_w, f), s,
             torch.cuda.current_stream(x_int.device).cuda_stream)
    _raise_on_error("conv_threshold", err)
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
