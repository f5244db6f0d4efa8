"""Mamba-1 selective-state-space block with a chunked scan.

The counterpart of ``repro.models.ssm``, on torch tensors with the
reference's parameter names, shapes and dtypes: ``A_log``, ``D`` and
``dt_proj.b`` are float32 whatever ``cfg.dtype`` is, and so is the decode
cache's ``h``. The reference is jnp throughout (``lax.scan`` over chunks,
``associative_scan`` inside one); here the chunked scan is a Python loop
over chunks with a log-depth (Hillis-Steele) scan of the same combine
inside each chunk, so a chunk of c steps costs log2(c) rounds of
elementwise ops, not c. Each chunk's decay and input terms are formed
from that chunk's slice, so the (B, T, d_inner, state) tensors of the
whole sequence are never held at once. The scan sums in another order
than the reference's tree, so float32 results agree to rounding.

``ssm_decode`` writes the step's conv window and state into the cache it
is given (``copy_``), as ``attention.attn_decode`` writes K/V: the layer
stack hands each sublayer views of the stacked caches and keeps no
returned copy.

``selective_scan_ref`` is the per-step oracle the tests use.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (_dtype, _normal, leaf_dtype,
                                       linear_apply, linear_init)


# ---------------------------------------------------------------------------
# selective scan
# ---------------------------------------------------------------------------

def selective_scan_ref(x, dt, B_t, C_t, A, D, h0=None):
    """Naive sequential oracle.

    x, dt: (B, T, di); B_t, C_t: (B, T, st); A: (di, st); D: (di,).
    Returns (y (B, T, di), h_last (B, di, st))."""
    Bsz, T, di = x.shape
    h = (torch.zeros((Bsz, di, A.shape[1]), dtype=torch.float32,
                     device=x.device) if h0 is None else h0)
    xf, dtf = x.to(torch.float32), dt.to(torch.float32)
    bf, cf = B_t.to(torch.float32), C_t.to(torch.float32)
    ys = []
    for t in range(T):
        da = torch.exp(dtf[:, t, :, None] * A)
        db = (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :]
        h = da * h + db
        ys.append(torch.einsum("bds,bs->bd", h, cf[:, t]))
    y = torch.stack(ys, dim=1) + xf * D
    return y.to(x.dtype), h


def _scan_chunk(a, b):
    """Inclusive scan along axis 1 of h_t = a_t h_{t-1} + b_t (h_{-1} = 0):
    Hillis-Steele over the reference's ``_assoc_combine``, element t
    combined with element t - s for s = 1, 2, 4, ...; returns every h_t."""
    n, s = a.shape[1], 1
    while s < n:
        b = torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1)
        if 2 * s < n:
            a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return b


def selective_scan_chunked(x, dt, B_t, C_t, A, D, chunk: int, h0=None):
    """Chunked selective scan: a loop over chunks carrying h, a log-depth
    scan inside each. Same signature and semantics as
    ``selective_scan_ref``; T must be a multiple of the chunk (taken as
    ``min(chunk, T)``)."""
    Bsz, T, di = x.shape
    chunk = min(chunk, T)
    if T % chunk:
        raise ValueError(f"seq {T} not divisible by ssm chunk {chunk}")
    xf, dtf = x.to(torch.float32), dt.to(torch.float32)
    bf, cf = B_t.to(torch.float32), C_t.to(torch.float32)
    h = (torch.zeros((Bsz, di, A.shape[1]), dtype=torch.float32,
                     device=x.device) if h0 is None else h0)
    ys = []
    for c0 in range(0, T, chunk):
        sl = slice(c0, c0 + chunk)
        a = torch.exp(dtf[:, sl, :, None] * A)                # (B,c,di,st)
        b = (dtf[:, sl] * xf[:, sl])[..., None] * bf[:, sl, None, :]
        b = torch.cat([b[:, :1] + a[:, :1] * h[:, None], b[:, 1:]], dim=1)
        h_all = _scan_chunk(a, b)
        ys.append(torch.einsum("bcds,bcs->bcd", h_all, cf[:, sl]))
        h = h_all[:, -1]
    y = torch.cat(ys, dim=1) + xf * D
    return y.to(x.dtype), h


def selective_scan_step(x_t, dt_t, b_t, c_t, A, D, h):
    """Single decode step. x_t/dt_t (B, di); b_t/c_t (B, st); h (B, di, st)."""
    da = torch.exp(dt_t.to(torch.float32)[..., None] * A)
    db = ((dt_t * x_t).to(torch.float32)[..., None]
          * b_t.to(torch.float32)[:, None, :])
    h = da * h + db
    y = (torch.einsum("bds,bs->bd", h, c_t.to(torch.float32))
         + x_t.to(torch.float32) * D)
    return y.to(x_t.dtype), h


# ---------------------------------------------------------------------------
# depthwise causal conv (K small: explicit shift-and-add)
# ---------------------------------------------------------------------------

def causal_conv1d(x, w, b, state=None):
    """x (B, T, di), w (K, di), b (di,). state (B, K-1, di) holds the last
    K-1 inputs of the previous segment (decode). Returns (y, new_state)."""
    K, T = w.shape[0], x.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)                         # (B, T+K-1, di)
    y = sum(xp[:, j:j + T] * w[j] for j in range(K))
    new_state = xp[:, -(K - 1):] if K > 1 else state
    return y + b, new_state


# ---------------------------------------------------------------------------
# mamba block
# ---------------------------------------------------------------------------

def ssm_init(generator, cfg: ArchConfig, device=None):
    d, di, st, dtr, K = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                         cfg.dt_rank, cfg.ssm_conv)
    f32 = torch.float32
    in_proj = linear_init(generator, d, 2 * di, cfg, device=device)
    conv_w = _normal((K, di), K ** -0.5, cfg, generator, device,
                     truncated=False)
    x_proj = linear_init(generator, di, dtr + 2 * st, cfg, device=device)
    dt_w = _normal((dtr, di), dtr ** -0.5, cfg, generator, device,
                   truncated=False)
    # dt bias: inverse-softplus of uniform[1e-3, 1e-1] (mamba init)
    u = torch.empty(di, dtype=f32, device=device).uniform_(
        1e-3, 1e-1, generator=generator)
    out_proj = linear_init(generator, di, d, cfg,
                           scale=(2 * cfg.n_layers * di) ** -0.5,
                           device=device)
    steps = torch.arange(1, st + 1, dtype=f32, device=device)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros(di, dtype=_dtype(cfg), device=device),
        "x_proj": x_proj,
        "dt_proj": {"w": dt_w, "b": torch.log(torch.expm1(u)).to(
            leaf_dtype(cfg, ("dt_proj", "b")))},
        "A_log": torch.log(steps)[None, :].expand(di, st).contiguous().to(
            leaf_dtype(cfg, ("A_log",))),
        "D": torch.ones(di, dtype=leaf_dtype(cfg, ("D",)), device=device),
        "out_proj": out_proj,
    }


def _mix(cfg: ArchConfig, p, x, conv_state=None):
    """The shared front of prefill and decode: in_proj, the causal conv,
    SiLU, x_proj and dt. Returns (xs, z, dt, B_t, C_t, A, new conv
    state)."""
    dtr, st = cfg.dt_rank, cfg.ssm_state
    xs, z = torch.chunk(linear_apply(cfg, p["in_proj"], x), 2, dim=-1)
    xs, conv_state = causal_conv1d(xs, p["conv_w"], p["conv_b"], conv_state)
    xs = F.silu(xs.to(torch.float32)).to(x.dtype)
    dbc = linear_apply(cfg, p["x_proj"], xs)
    dt_r, B_t, C_t = torch.split(dbc, [dtr, st, st], dim=-1)
    # dt_proj through linear_apply (QAT fake-quant and the int8 serve
    # path's w_int apply), every leaf but the bias, added in float32 below
    dt_lin = linear_apply(cfg, {k: v for k, v in p["dt_proj"].items()
                                if k != "b"}, dt_r)
    dt = F.softplus(dt_lin.to(torch.float32) + p["dt_proj"]["b"])
    A = -torch.exp(p["A_log"])
    return xs, z, dt, B_t, C_t, A, conv_state


def ssm_apply(cfg: ArchConfig, p, x):
    """Training / prefill forward. x (B, T, d) -> (B, T, d)."""
    xs, z, dt, B_t, C_t, A, _ = _mix(cfg, p, x)
    y, _ = selective_scan_chunked(xs, dt, B_t, C_t, A, p["D"], cfg.ssm_chunk)
    y = y * F.silu(z.to(torch.float32)).to(y.dtype)
    return linear_apply(cfg, p["out_proj"], y)


def ssm_cache_init(cfg: ArchConfig, batch: int, dtype=None, device=None):
    """The conv window in ``dtype`` (None: the config's) and the float32
    state."""
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                            dtype=dtype or _dtype(cfg), device=device),
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                         dtype=torch.float32, device=device),
    }


def ssm_decode(cfg: ArchConfig, p, x, cache):
    """One decode step. x (B, 1, d) -> (y (B, 1, d), cache), the step's
    conv window and state written into ``cache`` in place."""
    xs, z, dt, B_t, C_t, A, conv_state = _mix(cfg, p, x, cache["conv"])
    y, h = selective_scan_step(xs[:, 0], dt[:, 0], B_t[:, 0], C_t[:, 0], A,
                               p["D"], cache["h"])
    cache["conv"].copy_(conv_state)
    cache["h"].copy_(h)
    y = y[:, None] * F.silu(z.to(torch.float32)).to(y.dtype)
    return linear_apply(cfg, p["out_proj"], y), cache
