"""Foundational layers shared by every architecture in the zoo (the port of
``repro.models.layers``).

Numerics contract: parameters are stored f32, activations and matmuls run
in the config compute dtype (bf16 at scale), and reductions that need it
(norms, softmax, online-softmax accumulators) run f32. Where the reference
asks an einsum for an f32 result of low-precision inputs
(``preferred_element_type``), the port widens the inputs to f32 first: the
products of bf16 values are exact in f32, so the sum is the same f32
accumulation.

Attention is chunked online softmax (flash-style, plain PyTorch):
  * full/causal: a loop over q chunks × a loop over kv chunks with running
    (max, sum, acc): O(q_chunk × S) peak memory instead of O(S²). Causal
    masking is applied per chunk pair, so the work is rectangular (twice
    the causal useful work).
  * sliding window: per q chunk, a slice of width (window + q_chunk) from
    a front-padded KV: O(S · window) work.
  * decode: a single-position query against a (possibly ring-buffered)
    cache with explicit per-slot position masking: one code path for full
    and SWA caches.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` string ("bfloat16", ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _f32(x):
    return x.to(torch.float32)


# ---------------------------------------------------------------- norms ----


def rms_norm(x, w, eps: float = 1e-5):
    x32 = _f32(x)
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def layer_norm(x, w, b, eps: float = 1e-5):
    x32 = _f32(x)
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)   # population variance
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * w.to(x.dtype) + b.to(x.dtype)


# ----------------------------------------------------------------- rope ----


def rope_freqs(hd: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))


@functools.lru_cache(maxsize=None)
def _freqs_on(hd: int, theta: float, device: torch.device):
    """``rope_freqs`` on ``device``, copied there once: a copy from host
    memory at every call would wait for the device each time (decode
    would stop overlapping its launches with the card's work)."""
    return torch.from_numpy(rope_freqs(hd, theta)).to(device)


def _rotate(x, ang):
    # x (..., hd): rotate-half convention; ang (..., hd/2)
    x1, x2 = x.chunk(2, dim=-1)
    cos = torch.cos(ang).to(x.dtype)
    sin = torch.sin(ang).to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def apply_rope(x, pos, theta: float):
    """x (B,S,N,hd), pos (B,S) int32."""
    freqs = _freqs_on(x.shape[-1], theta, x.device)
    ang = _f32(pos)[..., None] * freqs   # (B,S,hd/2)
    return _rotate(x, ang[:, :, None, :])


MROPE_FRACTIONS = (0.25, 0.375, 0.375)  # t / h / w sections (Qwen2-VL)


def apply_mrope(x, pos3, theta: float):
    """M-RoPE: x (B,S,N,hd), pos3 (B,S,3) int32 — sectioned frequencies."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = _freqs_on(hd, theta, x.device)
    n0 = int(half * MROPE_FRACTIONS[0])
    n1 = int(half * MROPE_FRACTIONS[1])
    # section of each frequency: n0 zeros, n1 ones, the rest twos
    f = torch.arange(half, device=x.device)
    sec = (f >= n0).long() + (f >= n0 + n1).long()
    pos_per_freq = _f32(pos3)[..., sec]   # (B,S,half)
    ang = pos_per_freq * freqs
    return _rotate(x, ang[:, :, None, :])


# ------------------------------------------------------------ attention ----

NEG_INF = float(np.float32(-1e30))   # the f32 value, exactly


def _qkv_scores(q, k):
    """q (B,C,KV,G,hd), k (B,T,KV,hd) -> scores (B,KV,G,C,T), f32."""
    return torch.einsum("bckgh,btkh->bkgct", _f32(q), _f32(k))


def _apply_scores(p, v, *, f32_acc: bool = False):
    """p (B,KV,G,C,T), v (B,T,KV,hd) -> (B,C,KV,G,hd)."""
    if f32_acc:
        return torch.einsum("bkgct,btkh->bckgh", _f32(p), _f32(v))
    return torch.einsum("bkgct,btkh->bckgh", p.to(v.dtype), v)


def _online_block(carry, scores, v_blk, mask):
    """One online-softmax accumulation step; all accumulators f32.

    carry = (m (B,KV,G,C), l (B,KV,G,C), acc (B,C,KV,G,hd) f32)."""
    m, l, acc = carry
    scores = torch.where(mask, scores, NEG_INF)
    m_blk = scores.amax(-1)
    m_new = torch.maximum(m, m_blk)
    # guard fully-masked rows
    safe_m = torch.where(m_new == NEG_INF, 0.0, m_new)
    p = torch.exp(scores - safe_m[..., None])
    p = torch.where(mask, p, 0.0)
    corr = torch.exp(torch.where(m == NEG_INF, NEG_INF, m - safe_m))
    # the row sum reads the f32 tile, the apply product a tile cast to
    # v's dtype (the reference's contract)
    l_new = l * corr + p.sum(-1)
    acc_new = acc * corr.permute(0, 3, 1, 2)[..., None] \
        + _apply_scores(p.to(v_blk.dtype), v_blk, f32_acc=True)
    return (m_new, l_new, acc_new)


def _finish(carry, dtype):
    m, l, acc = carry
    denom = l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
    return (acc / denom).to(dtype)


def _init_carry(B, KV, G, q_chunk, hd, device):
    f32 = torch.float32
    return (torch.full((B, KV, G, q_chunk), NEG_INF, dtype=f32, device=device),
            torch.zeros((B, KV, G, q_chunk), dtype=f32, device=device),
            torch.zeros((B, q_chunk, KV, G, hd), dtype=f32, device=device))


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              q_chunk: int = 1024, kv_chunk: int = 1024):
    """Chunked online-softmax attention.

    q (B,S,H,hd); k,v (B,S,KV,hd); GQA by grouping: head h reads KV head
    h // G. Returns (B,S,H,hd).
    """
    B, S, H, hd = q.shape
    S_kv = k.shape[1]
    KV = k.shape[2]
    G = H // KV
    dev = q.device
    scale = float(1.0 / np.sqrt(hd))
    q = (q * scale).reshape(B, S, KV, G, hd)
    q_chunk = min(q_chunk, S)
    # pad both sequence axes to chunk multiples; masks keep padding inert
    S_p = -(-S // q_chunk) * q_chunk
    if S_p != S:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, S_p - S))
    n_q = S_p // q_chunk

    if window and S > window:
        return _attention_swa(q, k, v, window=window, q_chunk=q_chunk)[:, :S]

    kv_chunk = min(kv_chunk, S_kv)
    S_kv_p = -(-S_kv // kv_chunk) * kv_chunk
    if S_kv_p != S_kv:
        k = F.pad(k, (0, 0, 0, 0, 0, S_kv_p - S_kv))
        v = F.pad(v, (0, 0, 0, 0, 0, S_kv_p - S_kv))
    n_kv = S_kv_p // kv_chunk
    outs = []
    for i in range(n_q):
        q_blk = q[:, i * q_chunk:(i + 1) * q_chunk]
        q_pos = i * q_chunk + torch.arange(q_chunk, device=dev)
        carry = _init_carry(B, KV, G, q_chunk, hd, dev)
        for j in range(n_kv):
            k_blk = k[:, j * kv_chunk:(j + 1) * kv_chunk]
            v_blk = v[:, j * kv_chunk:(j + 1) * kv_chunk]
            kv_pos = j * kv_chunk + torch.arange(kv_chunk, device=dev)
            scores = _qkv_scores(q_blk, k_blk)
            valid = (kv_pos < S_kv)[None, :]
            if causal:
                mask = (kv_pos[None, :] <= q_pos[:, None]) & valid
            else:
                mask = valid.expand(q_chunk, kv_chunk)
            carry = _online_block(carry, scores, v_blk, mask)
        outs.append(_finish(carry, v.dtype))
    return torch.cat(outs, 1).reshape(B, S_p, H, hd)[:, :S]


def _attention_swa(q, k, v, *, window: int, q_chunk: int):
    """Sliding-window attention: O(S·window) work via per-chunk KV slices.
    q (B,S_p,KV,G,hd) scaled and padded to whole chunks."""
    B, S_p, KV, G, hd = q.shape
    S = k.shape[1]
    dev = q.device
    W = window + q_chunk  # slice width covering the chunk's full span
    # front pad = window (positions < 0); back pad keeps the last (possibly
    # partial) q chunk's slice in bounds — masks exclude both paddings.
    kp = F.pad(k, (0, 0, 0, 0, window, S_p - S))
    vp = F.pad(v, (0, 0, 0, 0, window, S_p - S))
    outs = []
    for i in range(S_p // q_chunk):
        q_blk = q[:, i * q_chunk:(i + 1) * q_chunk]
        q_pos = i * q_chunk + torch.arange(q_chunk, device=dev)
        start = i * q_chunk  # padded index of real position i*q_chunk - window
        k_blk = kp[:, start:start + W]
        v_blk = vp[:, start:start + W]
        kv_pos = start - window + torch.arange(W, device=dev)
        scores = _qkv_scores(q_blk, k_blk)
        mask = ((kv_pos[None, :] <= q_pos[:, None])
                & (kv_pos[None, :] > q_pos[:, None] - window)
                & (kv_pos[None, :] >= 0))
        init = _init_carry(B, KV, G, q_chunk, hd, dev)
        outs.append(_finish(_online_block(init, scores, v_blk, mask),
                            v.dtype))
    return torch.cat(outs, 1).reshape(B, S_p, KV * G, hd)


def decode_attention(q, k_cache, v_cache, slot_pos, pos, *, window: int = 0):
    """Single-token attention against a cache.

    q (B,1,H,hd); caches (B,T,KV,hd); slot_pos (B,T) the absolute position
    stored in each cache slot (−1 = empty); pos (B,) current position.
    One code path for full and ring-buffered SWA caches.
    """
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    q = (q * float(1.0 / np.sqrt(hd))).reshape(B, 1, KV, G, hd)
    scores = _qkv_scores(q, k_cache)  # (B,KV,G,1,T)
    ok = (slot_pos >= 0) & (slot_pos <= pos[:, None])
    if window:
        ok &= slot_pos > (pos[:, None] - window)
    scores = torch.where(ok[:, None, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = _apply_scores(p, v_cache)
    return out.reshape(B, 1, H, hd)


# ------------------------------------------------------------------ mlp ----


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp(x, params, act: str):
    if act == "swiglu":
        h = x @ params["w1"].to(x.dtype)
        g = x @ params["w3"].to(x.dtype)
        h = F.silu(h) * g
    else:
        h = gelu(x @ params["w1"].to(x.dtype))
    return h @ params["w2"].to(x.dtype)


# ------------------------------------------------------------- lm parts ----


def embed(tokens, table, dtype):
    # cast the gathered rows, not the table: the same values
    return table[tokens.long()].to(dtype)


def unembed(x, table):
    """(B,S,d) -> (B,S,V) f32 logits, accumulated in f32."""
    return _f32(x) @ _f32(table.to(x.dtype)).T


def cross_entropy(logits, labels, mask=None):
    """Mean next-token CE; logits (B,S,V) f32, labels (B,S) int32."""
    logits = _f32(logits)
    lse = torch.logsumexp(logits, -1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is None:
        return nll.mean()
    mask = _f32(mask)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
