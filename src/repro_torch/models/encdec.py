"""Whisper-style encoder–decoder backbone (the port of
``repro.models.encdec``).

The audio frontend is a stub: ``input_specs`` supplies precomputed frame
embeddings (B, S_enc, d_model); a linear adapter stands in for the conv
stem. 32L means 32 encoder + 32 decoder layers (the whisper-large-v3
topology). Positions are sinusoidal (no params), norms are LayerNorm,
activations GELU, per the original. Decode carries a decoder
self-attention cache plus precomputed cross-attention K/V.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.engines import resolve_device
from . import layers as ll
from .transformer import (PD, _attn_defs, _ffn_defs, _head, _norm_defs,
                          _out_norm, cache_slot, layer, remat,
                          ring_cache_from_kv, stack_defs, write_slot)


def enc_seq_len(seq_len: int) -> int:
    return max(seq_len // 4, 8)


def model_defs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    enc_block = {}
    enc_block.update(_norm_defs(cfg, "ln1"))
    enc_block["attn"] = _attn_defs(cfg)
    enc_block.update(_norm_defs(cfg, "ln2"))
    enc_block["ffn"] = _ffn_defs(cfg)

    dec_block = {}
    dec_block.update(_norm_defs(cfg, "ln1"))
    dec_block["attn"] = _attn_defs(cfg)
    dec_block.update(_norm_defs(cfg, "lnx"))
    dec_block["xattn"] = _attn_defs(cfg)
    dec_block.update(_norm_defs(cfg, "ln2"))
    dec_block["ffn"] = _ffn_defs(cfg)

    defs = {
        "adapter": PD((d, d), ("embed", None)),      # conv-stem stand-in
        "embed": PD((cfg.vocab, d), ("vocab", "embed")),
        "enc_blocks": stack_defs(cfg.n_layers, enc_block),
        "dec_blocks": stack_defs(cfg.n_layers, dec_block),
    }
    defs.update({f"out_{k}": v for k, v in _norm_defs(cfg, "norm").items()})
    defs.update({f"enc_out_{k}": v for k, v in _norm_defs(cfg, "norm").items()})
    if not cfg.tie_embeddings:
        defs["lm_head"] = PD((cfg.vocab, d), ("vocab", "embed"))
    return defs


def _sinusoid(S: int, d: int, dtype, device):
    """Prefill positions: computed in numpy f64, then cast to ``dtype``."""
    pos = np.arange(S)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10_000.0, 2 * i / d)
    pe = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    return torch.from_numpy(pe).to(device=device, dtype=dtype)


def _sinusoid_at(pos: int, d: int, dtype, device):
    """Decode position ``pos``: computed in f32 (not the prefill table)."""
    i = torch.arange(d // 2, dtype=torch.float32, device=device)
    ang = torch.full((), pos, dtype=torch.float32, device=device) \
        / torch.pow(10_000.0, 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)])[None, None, :] \
        .to(dtype)


def _norm(cfg, p, name, x):
    return ll.layer_norm(x, p[f"{name}_w"], p[f"{name}_b"], cfg.norm_eps)


def _proj_heads(cfg, w, x, n_heads):
    B, S, _ = x.shape
    return (x @ w.to(x.dtype)).reshape(B, S, n_heads, cfg.hd)


def _out(p, o, B, S):
    return o.reshape(B, S, -1) @ p["wo"].to(o.dtype)


def _attn(cfg, p, x, kv_x, *, causal):
    B, S, _ = x.shape
    q = _proj_heads(cfg, p["wq"], x, cfg.n_heads)
    k = _proj_heads(cfg, p["wk"], kv_x, cfg.n_kv_heads)
    v = _proj_heads(cfg, p["wv"], kv_x, cfg.n_kv_heads)
    o = ll.attention(q, k, v, causal=causal, q_chunk=cfg.q_chunk,
                     kv_chunk=cfg.kv_chunk)
    return _out(p, o, B, S)


def encode(cfg: ArchConfig, params, frames):
    """frames (B, S_enc, d_model) -> encoder states."""
    dtype = ll.dtype_of(cfg.dtype)
    x = frames.to(dtype) @ params["adapter"].to(dtype)
    x = x + _sinusoid(x.shape[1], cfg.d_model, dtype, x.device)

    def body(p_l, xx):
        h = _norm(cfg, p_l, "ln1", xx)
        xx = xx + _attn(cfg, p_l["attn"], h, h, causal=False)
        return xx + ll.mlp(_norm(cfg, p_l, "ln2", xx), p_l["ffn"], cfg.act)

    for i in range(cfg.n_layers):
        x = remat(cfg, body, layer(params["enc_blocks"], i), x)
    return _out_norm(cfg, params, x, prefix="enc_out_")


def _embed_tokens(cfg, params, tokens, dtype):
    x = ll.embed(tokens, params["embed"], dtype)
    return x + _sinusoid(tokens.shape[1], cfg.d_model, dtype, x.device)


def forward(cfg: ArchConfig, params, batch):
    """Training forward: (logits over decoder positions, None, aux=0)."""
    dtype = ll.dtype_of(cfg.dtype)
    enc = encode(cfg, params, batch["frames"])
    x = _embed_tokens(cfg, params, batch["tokens"], dtype)

    def body(p_l, xx):
        h = _norm(cfg, p_l, "ln1", xx)
        xx = xx + _attn(cfg, p_l["attn"], h, h, causal=True)
        xx = xx + _attn(cfg, p_l["xattn"], _norm(cfg, p_l, "lnx", xx), enc,
                        causal=False)
        return xx + ll.mlp(_norm(cfg, p_l, "ln2", xx), p_l["ffn"], cfg.act)

    for i in range(cfg.n_layers):
        x = remat(cfg, body, layer(params["dec_blocks"], i), x)
    x = _out_norm(cfg, params, x)
    return ll.unembed(x, _head(cfg, params)), None, \
        torch.zeros((), dtype=torch.float32, device=x.device)


def init_cache(cfg: ArchConfig, batch_size: int, cache_len: int,
               enc_len: int, *, device=None):
    dev = resolve_device(device)
    dtype = ll.dtype_of(cfg.dtype)
    L, B, KV, hd = cfg.n_layers, batch_size, cfg.n_kv_heads, cfg.hd
    return {
        "k": torch.zeros((L, B, cache_len, KV, hd), dtype=dtype, device=dev),
        "v": torch.zeros((L, B, cache_len, KV, hd), dtype=dtype, device=dev),
        "slot_pos": torch.full((L, B, cache_len), -1, dtype=torch.int32,
                               device=dev),
        "xk": torch.zeros((L, B, enc_len, KV, hd), dtype=dtype, device=dev),
        "xv": torch.zeros((L, B, enc_len, KV, hd), dtype=dtype, device=dev),
        "x_pos": torch.zeros((L, B, enc_len), dtype=torch.int32, device=dev),
    }


def prefill(cfg: ArchConfig, params, batch, cache_len: int):
    """Encode + run decoder over the prompt, building self+cross caches."""
    dtype = ll.dtype_of(cfg.dtype)
    enc = encode(cfg, params, batch["frames"])
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed_tokens(cfg, params, tokens, dtype)
    enc_pos = torch.arange(enc.shape[1], dtype=torch.int32,
                           device=x.device).expand(B, enc.shape[1])
    layers = []
    for i in range(cfg.n_layers):
        p_l = layer(params["dec_blocks"], i)
        h = _norm(cfg, p_l, "ln1", x)
        q = _proj_heads(cfg, p_l["attn"]["wq"], h, cfg.n_heads)
        k = _proj_heads(cfg, p_l["attn"]["wk"], h, cfg.n_kv_heads)
        v = _proj_heads(cfg, p_l["attn"]["wv"], h, cfg.n_kv_heads)
        o = ll.attention(q, k, v, causal=True, q_chunk=cfg.q_chunk,
                         kv_chunk=cfg.kv_chunk)
        x = x + _out(p_l["attn"], o, B, S)
        kc, vc, sp = ring_cache_from_kv(k, v, cache_len)
        xk = _proj_heads(cfg, p_l["xattn"]["wk"], enc, cfg.n_kv_heads)
        xv = _proj_heads(cfg, p_l["xattn"]["wv"], enc, cfg.n_kv_heads)
        x = x + _attn(cfg, p_l["xattn"], _norm(cfg, p_l, "lnx", x), enc,
                      causal=False)
        x = x + ll.mlp(_norm(cfg, p_l, "ln2", x), p_l["ffn"], cfg.act)
        layers.append({"k": kc, "v": vc, "slot_pos": sp, "xk": xk, "xv": xv,
                       "x_pos": enc_pos})
    cache = {k: torch.stack([cl[k] for cl in layers]) for k in layers[0]}
    x = _out_norm(cfg, params, x)
    return ll.unembed(x[:, -1:], _head(cfg, params)), cache


def decode_step(cfg: ArchConfig, params, cache, tokens, pos):
    """One decode step; the self-attention cache is updated IN PLACE (as
    ``transformer.decode_step``), at slot ``pos`` clamped into the cache as
    the reference's ``dynamic_update_slice`` clamps it."""
    pos = int(pos)
    dtype = ll.dtype_of(cfg.dtype)
    B = tokens.shape[0]
    x = ll.embed(tokens, params["embed"], dtype)
    x = x + _sinusoid_at(pos, cfg.d_model, dtype, x.device)
    T = cache["k"].shape[2]
    enc_len = cache["xk"].shape[2]
    pos_b = torch.full((B,), pos, dtype=torch.int32, device=x.device)
    # cross attention: every encoder slot is valid (pos = enc_len)
    enc_b = torch.full((B,), enc_len, dtype=torch.int32, device=x.device)
    for i in range(cfg.n_layers):
        p_l = layer(params["dec_blocks"], i)
        cl = layer(cache, i)
        h = _norm(cfg, p_l, "ln1", x)
        q = _proj_heads(cfg, p_l["attn"]["wq"], h, cfg.n_heads)
        k = _proj_heads(cfg, p_l["attn"]["wk"], h, cfg.n_kv_heads)
        v = _proj_heads(cfg, p_l["attn"]["wv"], h, cfg.n_kv_heads)
        write_slot(cl, k, v, pos, cache_slot(pos, T, 0))
        o = ll.decode_attention(q, cl["k"], cl["v"], cl["slot_pos"], pos_b)
        x = x + _out(p_l["attn"], o, B, 1)
        hq = _norm(cfg, p_l, "lnx", x)
        xq = _proj_heads(cfg, p_l["xattn"]["wq"], hq, cfg.n_heads)
        xo = ll.decode_attention(xq, cl["xk"], cl["xv"], cl["x_pos"], enc_b)
        x = x + _out(p_l["xattn"], xo, B, 1)
        x = x + ll.mlp(_norm(cfg, p_l, "ln2", x), p_l["ffn"], cfg.act)
    x = _out_norm(cfg, params, x)
    return ll.unembed(x, _head(cfg, params)), cache
