"""Selective SSM (Mamba-style) + the Hymba parallel attn∥SSM head (the port
of ``repro.models.ssm``).

The selective scan runs chunkwise: within a chunk of ``ssm_chunk`` steps a
log-step scan computes the diagonal recurrence in parallel; chunks carry
the (B, d, N) state, so peak memory is O(chunk · d · N) instead of
O(S · d · N).

Recurrence (diagonal A):   h_t = exp(Δ_t A) ⊙ h_{t−1} + Δ_t B_t x_t
Output:                    y_t = C_t · h_t + D ⊙ x_t
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def softplus(x):
    """``jax.nn.softplus``: log(1 + exp(x)) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _assoc_scan_chunk(a, b):
    """a, b (B, L, d, N): h_t = a_t h_{t-1} + b_t within the chunk.

    A log-step (Hillis-Steele) inclusive scan of the reference's combine
    ((a_x, b_x), (a_y, b_y)) -> (a_x a_y, a_y b_x + b_y): log2(L) steps,
    each combining element t with element t - off. It associates the
    products in another order than ``lax.associative_scan``, so f32 results
    agree to rounding."""
    L = a.shape[1]
    off = 1
    while off < L:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
        off *= 2
    return a, b


def selective_scan(x, dt, B_t, C_t, A_log, D, *, chunk: int = 128,
                   h0=None):
    """x (B,S,d); dt (B,S,d); B_t/C_t (B,S,N); A_log (d,N); D (d,).

    Returns y (B,S,d) and final state (B,d,N). S must be a multiple of
    ``min(chunk, S)`` (the reference's reshape fails otherwise).
    """
    Bsz, S, d = x.shape
    N = B_t.shape[-1]
    A = -torch.exp(A_log.to(torch.float32))              # (d, N), Re < 0
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"selective_scan: S = {S} is not a multiple of the "
                         f"chunk {chunk}")
    h = torch.zeros((Bsz, d, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0
    ys = []
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        xc, dtc, Bc, Cc = x[:, sl], dt[:, sl], B_t[:, sl], C_t[:, sl]
        a = torch.exp(dtc[..., None].to(torch.float32) * A)   # (B,L,d,N)
        b = (dtc * xc)[..., None].to(torch.float32) * Bc[:, :, None, :]
        # prepend carry via b_0' = a_0 h + b_0
        b[:, 0] += a[:, 0] * h
        _, hs = _assoc_scan_chunk(a, b)                   # (B,L,d,N)
        yc = torch.einsum("bldn,bln->bld", hs, Cc.to(torch.float32))
        ys.append(yc.to(x.dtype) + xc * D.to(x.dtype))
        h = hs[:, -1]
    return torch.cat(ys, 1), h


def selective_step(x, dt, B_t, C_t, A_log, D, h):
    """Single decode step. x/dt (B,d); B_t/C_t (B,N); h (B,d,N)."""
    A = -torch.exp(A_log.to(torch.float32))
    a = torch.exp(dt[..., None].to(torch.float32) * A)
    b = (dt * x)[..., None].to(torch.float32) * B_t[:, None, :]
    h = a * h + b
    y = torch.einsum("bdn,bn->bd", h, C_t.to(torch.float32))
    return y.to(x.dtype) + x * D.to(x.dtype), h


def _dt(xin, params):
    return softplus((xin @ params["w_dt"].to(xin.dtype))[..., None]
                    + params["dt_bias"].to(xin.dtype))


def mamba_head(x, params, *, state: int, chunk: int = 128, h0=None):
    """Full mamba head over a sequence. x (B,S,d) -> (y, final_state)."""
    xin = x @ params["w_in"].to(x.dtype)
    z = x @ params["w_gate"].to(x.dtype)
    dt = _dt(xin, params).expand(xin.shape)
    B_t = xin @ params["w_B"].to(x.dtype)
    C_t = xin @ params["w_C"].to(x.dtype)
    y, h = selective_scan(xin, dt, B_t, C_t, params["A_log"], params["D"],
                          chunk=chunk, h0=h0)
    y = y * F.silu(z)
    return y @ params["w_out"].to(x.dtype), h


def mamba_head_step(x, params, h):
    """Decode step. x (B,1,d), h (B,e,N)."""
    x1 = x[:, 0]
    xin = x1 @ params["w_in"].to(x.dtype)
    z = x1 @ params["w_gate"].to(x.dtype)
    dt = _dt(xin, params)
    B_t = xin @ params["w_B"].to(x.dtype)
    C_t = xin @ params["w_C"].to(x.dtype)
    y, h = selective_step(xin, dt, B_t, C_t, params["A_log"], params["D"], h)
    y = y * F.silu(z)
    return (y @ params["w_out"].to(x.dtype))[:, None], h
