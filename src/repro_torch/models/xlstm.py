"""xLSTM blocks: chunkwise-parallel mLSTM + recurrent sLSTM (arXiv:2405.04517;
the port of ``repro.models.xlstm``).

mLSTM keeps a matrix state C (B, H, dk, dv) and normalizer n (B, H, dk):

    C_t = f_t C_{t−1} + i_t k_t v_tᵀ        n_t = f_t n_{t−1} + i_t k_t
    y_t = (q_t · C_t) / max(|q_t · n_t|, 1)

Prefill runs the GLA-style chunkwise form: intra-chunk decay matrices in log
space (all decay ratios ≤ 1 ⇒ no overflow), the inter-chunk state carried
from chunk to chunk. Decode is the one-step recurrence. Simplifications vs
the paper (the reference's): the input gate uses sigmoid rather than
exp-with-stabilizer, and the causal-conv front is omitted.

sLSTM is the sequential scalar-memory cell with per-head recurrent mixing,
run step by step over time.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_F32 = torch.float32


# ------------------------------------------------------------- mLSTM -------


def _gates(x, params):
    """x (B,S,d) -> i (B,S,H) in (0,1), log-f (B,S,H) ≤ 0."""
    i = torch.sigmoid(x @ params["w_i"].to(x.dtype)
                      + params["b_i"].to(x.dtype))
    lf = F.logsigmoid((x @ params["w_f"].to(x.dtype)
                       + params["b_f"].to(x.dtype)).to(_F32))
    return i.to(_F32), lf


def mlstm_chunkwise(q, k, v, i, lf, *, chunk: int, carry=None):
    """q,k (B,S,H,dk); v (B,S,H,dv); i,lf (B,S,H) f32.

    Returns y (B,S,H,dv) and carry (C (B,H,dk,dv) f32, n (B,H,dk) f32).
    """
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    scale = float(1.0 / np.sqrt(dk))
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"mlstm_chunkwise: S = {S} is not a multiple of the "
                         f"chunk {chunk}")
    dev = q.device
    if carry is None:
        carry = (torch.zeros((B, H, dk, dv), dtype=_F32, device=dev),
                 torch.zeros((B, H, dk), dtype=_F32, device=dev))
    C, n = carry
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev))
    ys = []
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        qc, kc, vc, ic, lfc = q[:, sl], k[:, sl], v[:, sl], i[:, sl], lf[:, sl]
        Lc = torch.cumsum(lfc, 1)          # (B,L,H)
        LcT = Lc.transpose(1, 2)           # (B,H,L)
        D = LcT[:, :, :, None] - LcT[:, :, None, :]   # log decay t<-s
        # the inner where keeps exp from overflowing above the diagonal
        # (one where alone would give inf · 0 = NaN)
        w = torch.where(tri, torch.exp(torch.where(tri, D, 0.0)), 0.0)
        w = w * ic.transpose(1, 2)[:, :, None, :]     # × i_s
        scores = torch.einsum("blhk,bmhk->bhlm", qc.to(_F32),
                              kc.to(_F32)) * scale
        a = w * scores                                 # (B,H,L,L)
        y_intra = torch.einsum("bhlm,bmhv->blhv", a.to(vc.dtype), vc)
        den_intra = a.sum(-1).transpose(1, 2)          # (B,L,H)

        eL = torch.exp(Lc)                             # ≤ 1 decays
        qs = qc.to(_F32) * scale
        y_inter = torch.einsum("blhk,bhkv->blhv", qs, C) * eL[..., None]
        den_inter = torch.einsum("blhk,bhk->blh", qs, n) * eL
        den = (den_intra + den_inter).abs().clamp_min(1.0)
        y = (y_intra.to(_F32) + y_inter) / den[..., None]

        dec_end = torch.exp(Lc[:, -1:, :] - Lc)        # (B,L,H), ≤ 1
        ik = (ic * dec_end)[..., None] * kc.to(_F32)
        f_end = torch.exp(Lc[:, -1])                   # (B,H)
        C = C * f_end[:, :, None, None] + torch.einsum(
            "blhk,blhv->bhkv", ik, vc.to(_F32))
        n = n * f_end[:, :, None] + ik.sum(1)          # (B,H,dk)
        ys.append(y.to(v.dtype))
    return torch.cat(ys, 1), (C, n)


def mlstm_step(q, k, v, i, lf, carry):
    """Single decode step. q,k (B,H,dk); v (B,H,dv); i,lf (B,H)."""
    C, n = carry
    scale = float(1.0 / np.sqrt(q.shape[-1]))
    f = torch.exp(lf)[..., None]
    k32 = k.to(_F32)
    C = C * f[..., None] + (i[..., None] * k32)[..., None] \
        * v.to(_F32)[:, :, None, :]
    n = n * f + i[..., None] * k32
    qs = q.to(_F32) * scale
    y = torch.einsum("bhk,bhkv->bhv", qs, C)
    den = torch.einsum("bhk,bhk->bh", qs, n).abs().clamp_min(1.0)
    return (y / den[..., None]).to(v.dtype), (C, n)


def mlstm_block(x, params, *, n_heads: int, chunk: int, carry=None,
                step: bool = False):
    """Full mLSTM residual block body (pre-norm residual handled by caller).

    x (B,S,d). proj-factor 2: e = 2d; v dim e/H, qk dim d/H.
    """
    B, S, d = x.shape
    e = params["w_up"].shape[1] // 2
    H = n_heads
    dv, dqk = e // H, d // H
    up = x @ params["w_up"].to(x.dtype)
    u, z = up.chunk(2, dim=-1)
    q = (u @ params["w_q"].to(x.dtype)).reshape(B, S, H, dqk)
    k = (u @ params["w_k"].to(x.dtype)).reshape(B, S, H, dqk)
    v = u.reshape(B, S, H, dv)
    i, lf = _gates(x, params)
    if step:
        y, carry = mlstm_step(q[:, 0], k[:, 0], v[:, 0], i[:, 0], lf[:, 0],
                              carry)
        y = y[:, None]
    else:
        y, carry = mlstm_chunkwise(q, k, v, i, lf, chunk=chunk, carry=carry)
    y = y.reshape(B, S, e) * F.silu(z)
    return y @ params["w_down"].to(x.dtype), carry


# ------------------------------------------------------------- sLSTM -------


def slstm_block(x, params, *, n_heads: int, carry=None, step: bool = False):
    """Sequential sLSTM with per-head recurrent mixing.

    x (B,S,d). carry = (h, c, n) each (B, d) f32. Gate order i, f, z, o.
    """
    B, S, d = x.shape
    H = n_heads
    dh = d // H
    if carry is None:
        carry = tuple(torch.zeros((B, d), dtype=_F32, device=x.device)
                      for _ in range(3))

    wx = params["w_x"].to(x.dtype)       # (d, 4d)
    r = params["r"].to(_F32)             # (H, dh, 4dh) recurrent, per head
    b = params["b"].to(_F32)             # (4d,)
    gx_all = (x @ wx).to(_F32)           # (B,S,4d)

    def cell(st, gx):
        h, c, n = st
        hr = torch.einsum("bhd,hde->bhe", h.reshape(B, H, dh), r) \
            .reshape(B, 4 * d)
        g = gx + hr + b
        gi, gf, gz, go = g.chunk(4, dim=-1)
        i = torch.sigmoid(gi)
        f = torch.sigmoid(gf)
        z = torch.tanh(gz)
        o = torch.sigmoid(go)
        c = f * c + i * z
        n = f * n + i
        h = o * c / n.clamp_min(1.0)
        return (h, c, n), h

    hs = []
    for t in range(1 if step else S):
        carry, h = cell(carry, gx_all[:, t])
        hs.append(h)
    ys = torch.stack(hs, 1)
    y = ys.to(x.dtype) @ params["w_out"].to(x.dtype)
    return y, carry
