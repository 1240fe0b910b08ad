"""Decoder-only model assembly for every non-enc-dec architecture (the port
of ``repro.models.transformer``).

One config-driven family: GQA/SWA attention blocks (dense + MoE), Hymba
parallel attn∥SSM blocks, and xLSTM superblocks. Parameters keep the
reference's tree: a nested dict whose leaves carry the leading layer axis
(``(L, ...)``, and ``(n_super, n_m, ...)`` for the mLSTM layers); the layer
loops index it.

Parameters are declared as ``PD(shape, logical_axes, init)`` leaves; the
same declaration drives initialization (f32) and the logical axes a
sharding layer maps onto devices (``param_axes``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.utils.checkpoint

from ..configs.base import ArchConfig
from ..core.engines import resolve_device
from . import layers as ll
from . import moe as moe_mod
from . import ssm as ssm_mod
from . import xlstm as xl

_F32 = torch.float32


class PD(NamedTuple):
    shape: tuple
    axes: tuple          # logical axis names, len == len(shape)
    init: str = "normal"  # normal | normal_out | zeros | ones | f_bias | a_log


def tree_map(fn, tree):
    """``fn`` over the leaves of a nested dict (a ``PD`` is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree, path=()):
    """(path, leaf) pairs in ``jax.tree.flatten``'s order (sorted keys)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], path + (k,))
    else:
        yield path, tree


def layer(tree, i):
    """Layer ``i`` of a stacked tree: every leaf indexed on its first axis."""
    return tree_map(lambda a: a[i], tree)


# ------------------------------------------------------- param definitions -


def _attn_defs(cfg: ArchConfig) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    defs = {
        "wq": PD((d, H * hd), ("embed", "heads")),
        "wk": PD((d, KV * hd), ("embed", "kv")),
        "wv": PD((d, KV * hd), ("embed", "kv")),
        "wo": PD((H * hd, d), ("heads", "embed"), "normal_out"),
    }
    if cfg.qk_norm:
        defs["q_norm"] = PD((hd,), ("hd",), "ones")
        defs["k_norm"] = PD((hd,), ("hd",), "ones")
    return defs


def _norm_defs(cfg: ArchConfig, name: str) -> dict:
    if cfg.norm == "ln":
        return {f"{name}_w": PD((cfg.d_model,), ("embed",), "ones"),
                f"{name}_b": PD((cfg.d_model,), ("embed",), "zeros")}
    return {f"{name}_w": PD((cfg.d_model,), ("embed",), "ones")}


def _ffn_defs(cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.is_moe:
        # experts carry their own logical axis (expert parallelism); d keeps
        # one of its own so expert weights can stay sharded when the dense
        # weights are not
        e = cfg.n_experts
        defs = {
            "router": PD((d, e), ("embed", "experts")),
            "w1": PD((e, d, f), ("experts", "expert_embed", None)),
            "w2": PD((e, f, d), ("experts", None, "expert_embed"),
                     "normal_out"),
        }
        if cfg.act == "swiglu":
            defs["w3"] = PD((e, d, f), ("experts", "expert_embed", None))
        return defs
    if f == 0:
        return {}
    defs = {
        "w1": PD((d, f), ("embed", "ff")),
        "w2": PD((f, d), ("ff", "embed"), "normal_out"),
    }
    if cfg.act == "swiglu":
        defs["w3"] = PD((d, f), ("embed", "ff"))
    return defs


def _mamba_defs(cfg: ArchConfig) -> dict:
    d, N = cfg.d_model, cfg.ssm_state
    e = d  # inner width
    return {
        "w_in": PD((d, e), ("embed", "ff")),
        "w_gate": PD((d, e), ("embed", "ff")),
        "w_dt": PD((e,), ("ff",)),
        "dt_bias": PD((1,), (None,), "zeros"),
        "w_B": PD((e, N), ("ff", "state")),
        "w_C": PD((e, N), ("ff", "state")),
        "A_log": PD((e, N), ("ff", "state"), "a_log"),
        "D": PD((e,), ("ff",), "ones"),
        "w_out": PD((e, d), ("ff", "embed"), "normal_out"),
    }


def _mlstm_defs(cfg: ArchConfig) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    e = 2 * d
    return {
        "w_up": PD((d, 2 * e), ("embed", "ff")),
        "w_q": PD((e, d), ("ff", None)),   # row-parallel: contract over e
        "w_k": PD((e, d), ("ff", None)),
        "w_i": PD((d, H), ("embed", None)),
        "b_i": PD((H,), (None,), "zeros"),
        "w_f": PD((d, H), ("embed", None)),
        "b_f": PD((H,), (None,), "f_bias"),
        "w_down": PD((e, d), ("ff", "embed"), "normal_out"),
        "norm_w": PD((d,), ("embed",), "ones"),
    }


def _slstm_defs(cfg: ArchConfig) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    return {
        "w_x": PD((d, 4 * d), ("embed", "ff")),
        "r": PD((H, dh, 4 * dh), (None, "hd", None)),
        "b": PD((4 * d,), ("ff",), "zeros"),
        "w_out": PD((d, d), ("embed", None), "normal_out"),
        "norm_w": PD((d,), ("embed",), "ones"),
    }


def block_defs(cfg: ArchConfig) -> dict:
    """Parameter defs for ONE layer (caller stacks over layers)."""
    if cfg.block == "xlstm":
        raise ValueError("xlstm uses superblock defs")
    defs = {}
    defs.update(_norm_defs(cfg, "ln1"))
    defs["attn"] = _attn_defs(cfg)
    if cfg.block == "hymba":
        defs["ssm"] = _mamba_defs(cfg)
        defs["mix_a"] = PD((1,), (None,), "ones")
        defs["mix_s"] = PD((1,), (None,), "ones")
    ffn = _ffn_defs(cfg)
    if ffn:
        defs.update(_norm_defs(cfg, "ln2"))
        defs["ffn"] = ffn
    return defs


def stack_defs(n: int, defs):
    """``defs`` with a leading layer axis of ``n``."""
    return tree_map(lambda v: PD((n,) + v.shape, ("layers",) + v.axes,
                                 v.init), defs)


def _xlstm_dims(cfg: ArchConfig):
    """(n_super, n_m): superblocks of n_m mLSTM + 1 sLSTM layers;
    ``slstm_every = 0`` gives one superblock."""
    every = cfg.slstm_every or (cfg.n_layers + 1)
    return max(1, cfg.n_layers // every), every - 1


def model_defs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    defs = {"embed": PD((cfg.vocab, d), ("vocab", "embed"))}
    defs.update({f"out_{k}": v for k, v in _norm_defs(cfg, "norm").items()})
    if not cfg.tie_embeddings:
        defs["lm_head"] = PD((cfg.vocab, d), ("vocab", "embed"))
    if cfg.block == "xlstm":
        n_super, n_m = _xlstm_dims(cfg)
        defs["m_blocks"] = stack_defs(n_super,
                                      stack_defs(n_m, _mlstm_defs(cfg)))
        defs["s_blocks"] = stack_defs(n_super, _slstm_defs(cfg))
    else:
        defs["blocks"] = stack_defs(cfg.n_layers, block_defs(cfg))
    if cfg.frontend == "vision":
        defs["patch_proj"] = PD((d, d), ("embed", None))
    return defs


def _init_leaf(pd: PD, gen, device, cfg: ArchConfig):
    if pd.init == "zeros":
        return torch.zeros(pd.shape, dtype=_F32, device=device)
    if pd.init == "ones":
        return torch.ones(pd.shape, dtype=_F32, device=device)
    if pd.init == "f_bias":
        return torch.full(pd.shape, 3.0, dtype=_F32, device=device)
    if pd.init == "a_log":
        n = pd.shape[-1]
        base = torch.log(torch.arange(1, n + 1, dtype=_F32, device=device))
        return base.expand(pd.shape).contiguous()
    scale = 0.02
    if pd.init == "normal_out":
        scale = 0.02 / np.sqrt(max(2 * cfg.n_layers, 1))
    return float(scale) * torch.randn(pd.shape, generator=gen, dtype=_F32,
                                      device=device)


def init_params(cfg: ArchConfig, seed: int = 0, defs=None, *, device=None):
    """Random f32 parameters of ``defs`` (default ``model_defs(cfg)``),
    drawn leaf by leaf in sorted-key order from one ``torch.Generator``
    seeded with ``seed`` on ``device`` (default ``cuda``). The draws are
    not ``jax.random``'s; every init kind is the reference's."""
    dev = resolve_device(device)
    defs = defs or model_defs(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out: dict = {}
    for path, pd in tree_leaves(defs):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _init_leaf(pd, gen, dev, cfg)
    return out


def param_axes(cfg: ArchConfig, defs=None):
    return tree_map(lambda pd: pd.axes, defs or model_defs(cfg))


def param_shapes(cfg: ArchConfig, defs=None):
    """Meta tensors (f32) of every parameter: shapes without storage."""
    return tree_map(lambda pd: torch.empty(pd.shape, dtype=_F32,
                                           device="meta"),
                    defs or model_defs(cfg))


# ----------------------------------------------------------- block apply ---


def _norm(cfg, p, name, x):
    if cfg.norm == "ln":
        return ll.layer_norm(x, p[f"{name}_w"], p[f"{name}_b"], cfg.norm_eps)
    return ll.rms_norm(x, p[f"{name}_w"], cfg.norm_eps)


def _out_norm(cfg, params, x, prefix="out_"):
    return _norm(cfg, {k[len(prefix):]: v for k, v in params.items()
                       if k.startswith(prefix)}, "norm", x)


def _head(cfg, params):
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def _project_qkv(cfg, p, x, pos):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, H, hd)
    k = (x @ p["wk"].to(x.dtype)).reshape(B, S, KV, hd)
    v = (x @ p["wv"].to(x.dtype)).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = ll.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = ll.rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope == "rope":
        pos1 = pos if pos.ndim == 2 else pos[..., 0]
        q = ll.apply_rope(q, pos1, cfg.rope_theta)
        k = ll.apply_rope(k, pos1, cfg.rope_theta)
    elif cfg.rope == "mrope":
        q = ll.apply_mrope(q, pos, cfg.rope_theta)
        k = ll.apply_mrope(k, pos, cfg.rope_theta)
    return q, k, v


def _attend(cfg, p, q, k, v, B, S):
    o = ll.attention(q, k, v, causal=True, window=cfg.window,
                     q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    return o.reshape(B, S, -1) @ p["wo"].to(q.dtype)


def attn_apply(cfg, p, x, pos):
    q, k, v = _project_qkv(cfg, p, x, pos)
    return _attend(cfg, p, q, k, v, *x.shape[:2])


def cache_slot(pos: int, T: int, window: int) -> int:
    """The cache slot decode writes position ``pos`` into: ``pos % T`` on a
    ring (sliding window), else ``pos`` clamped into [0, T - 1] as
    ``lax.dynamic_update_slice`` clamps its start: at ``pos ≥ T`` the
    reference overwrites slot T - 1."""
    return pos % T if window else min(max(pos, 0), T - 1)


def write_slot(cache_l, k, v, pos: int, slot: int):
    """Write one position's k, v (B,1,KV,hd) into a layer's cache, in place."""
    cache_l["k"][:, slot] = k[:, 0]
    cache_l["v"][:, slot] = v[:, 0]
    cache_l["slot_pos"][:, slot] = pos


def attn_decode_apply(cfg, p, x, cache_l, pos: int):
    """x (B,1,d); cache_l = {k,v (B,T,KV,hd), slot_pos (B,T)}; pos an int.
    Writes the position into ``cache_l`` in place and returns it."""
    B = x.shape[0]
    shape = (B, 1, 3) if cfg.rope == "mrope" else (B, 1)
    # text-only decode: all three M-RoPE position streams = pos
    posb = torch.full(shape, pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, posb)
    T = cache_l["k"].shape[1]
    write_slot(cache_l, k, v, pos, cache_slot(pos, T, cfg.window))
    o = ll.decode_attention(
        q, cache_l["k"], cache_l["v"], cache_l["slot_pos"],
        torch.full((B,), pos, dtype=torch.int32, device=x.device),
        window=cfg.window)
    return o.reshape(B, 1, -1) @ p["wo"].to(x.dtype), cache_l


def ffn_apply(cfg, p, x):
    if cfg.is_moe:
        return moe_mod.moe_ffn(x, p, n_experts=cfg.n_experts,
                               top_k=cfg.top_k,
                               capacity_factor=cfg.capacity_factor,
                               act=cfg.act)
    return ll.mlp(x, p, cfg.act), torch.zeros((), dtype=_F32,
                                               device=x.device)


def _mix(p, x, a, s):
    ma = p["mix_a"].to(x.dtype)
    ms = p["mix_s"].to(x.dtype)
    return x + (ma * a + ms * s) / (ma + ms + 1e-6)


def block_apply(cfg, p, x, pos, cache_l=None, decode_pos=None):
    """One residual block. Returns (x, new_cache_l, aux_loss). In decode
    (``decode_pos`` an int) the attention cache is updated in place."""
    decode = decode_pos is not None
    h = _norm(cfg, p, "ln1", x)
    new_cache = {}
    if cfg.block == "hymba":
        if decode:
            a, kvc = attn_decode_apply(cfg, p["attn"], h, cache_l, decode_pos)
            s, hstate = ssm_mod.mamba_head_step(h, p["ssm"],
                                                cache_l["ssm_h"])
            new_cache = dict(kvc, ssm_h=hstate)
        else:
            a = attn_apply(cfg, p["attn"], h, pos)
            s, hstate = ssm_mod.mamba_head(h, p["ssm"], state=cfg.ssm_state,
                                           chunk=cfg.ssm_chunk)
            if cache_l is not None:
                new_cache["ssm_h"] = hstate
        x = _mix(p, x, a, s)
    else:
        if decode:
            a, new_cache = attn_decode_apply(cfg, p["attn"], h, cache_l,
                                             decode_pos)
        else:
            a = attn_apply(cfg, p["attn"], h, pos)
        x = x + a
    aux = torch.zeros((), dtype=_F32, device=x.device)
    if "ffn" in p:
        y, aux = ffn_apply(cfg, p["ffn"], _norm(cfg, p, "ln2", x))
        x = x + y
    return x, new_cache, aux


# ------------------------------------------------------------ xlstm stack --


def _xlstm_carry(cfg, B, device):
    n_super, n_m = _xlstm_dims(cfg)
    H, d = cfg.n_heads, cfg.d_model
    dqk, dv = d // H, 2 * d // H
    return {
        "mC": torch.zeros((n_super, n_m, B, H, dqk, dv), dtype=_F32,
                          device=device),
        "mn": torch.zeros((n_super, n_m, B, H, dqk), dtype=_F32,
                          device=device),
        "sh": torch.zeros((n_super, 3, B, d), dtype=_F32, device=device),
    }


def xlstm_apply(cfg, params, x, carry=None, step=False):
    """Superblocks of (slstm_every−1) mLSTM + 1 sLSTM layers, in order.
    Returns x and a new carry (the input carry is not modified)."""
    n_super, n_m = _xlstm_dims(cfg)
    H = cfg.n_heads
    if carry is None:
        carry = _xlstm_carry(cfg, x.shape[0], x.device)
    mC, mn, sh = [], [], []
    for s in range(n_super):
        mp, sp = layer(params["m_blocks"], s), layer(params["s_blocks"], s)
        Cs, ns = [], []
        for j in range(n_m):
            mp_l = layer(mp, j)
            h = ll.rms_norm(x, mp_l["norm_w"], cfg.norm_eps)
            y, (C2, n2) = xl.mlstm_block(
                h, mp_l, n_heads=H, chunk=cfg.ssm_chunk,
                carry=(carry["mC"][s, j], carry["mn"][s, j]), step=step)
            x = x + y
            Cs.append(C2)
            ns.append(n2)
        h = ll.rms_norm(x, sp["norm_w"], cfg.norm_eps)
        y, sc = xl.slstm_block(h, sp, n_heads=H,
                               carry=tuple(carry["sh"][s]), step=step)
        x = x + y
        mC.append(torch.stack(Cs) if Cs else carry["mC"][s])
        mn.append(torch.stack(ns) if ns else carry["mn"][s])
        sh.append(torch.stack(sc))
    return x, {"mC": torch.stack(mC), "mn": torch.stack(mn),
               "sh": torch.stack(sh)}


# --------------------------------------------------------------- forward ---


def _positions(cfg, batch, B, S, device):
    if cfg.rope == "mrope":
        return batch["pos3"]
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def embed_inputs(cfg, params, batch, dtype):
    x = ll.embed(batch["tokens"], params["embed"], dtype)
    if cfg.frontend == "vision":
        # the patch embeddings replace the first P token embeddings
        pe = batch["patch_embeds"].to(dtype) @ params["patch_proj"].to(dtype)
        x = torch.cat([pe, x[:, pe.shape[1]:]], 1)
    return x


def remat(cfg: ArchConfig, body, p_l, x):
    """``body(p_l, x)`` for one block. With ``cfg.remat == "block"``, while
    autograd records it (grad mode on and ``x`` or a parameter of the
    block requiring grad), the block runs under activation checkpointing:
    the backward pass recomputes it from its inputs and keeps nothing of
    its inside (the reference's ``jax.checkpoint(..., nothing_saveable)``).
    A block draws no random numbers, so no RNG state is kept. Serving,
    where nothing requires grad, runs the block as it is."""
    if cfg.remat == "block" and torch.is_grad_enabled() and (
            x.requires_grad
            or any(t.requires_grad for _, t in tree_leaves(p_l))):
        return torch.utils.checkpoint.checkpoint(
            body, p_l, x, use_reentrant=False, preserve_rng_state=False)
    return body(p_l, x)


def forward(cfg: ArchConfig, params, batch):
    """Full-sequence forward. Returns (logits, None, aux): caches are built
    by ``prefill``."""
    dtype = ll.dtype_of(cfg.dtype)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_inputs(cfg, params, batch, dtype)
    pos = _positions(cfg, batch, B, S, x.device)

    if cfg.block == "xlstm":
        x, _ = xlstm_apply(cfg, params, x)
        aux = torch.zeros((), dtype=_F32, device=x.device)
    else:
        def body(p_l, xx):
            xx, _, aux_l = block_apply(cfg, p_l, xx, pos)
            return xx, aux_l

        auxs = []
        for i in range(cfg.n_layers):
            x, aux_l = remat(cfg, body, layer(params["blocks"], i), x)
            auxs.append(aux_l)
        aux = torch.stack(auxs).sum()
    x = _out_norm(cfg, params, x)
    return ll.unembed(x, _head(cfg, params)), None, aux


# ------------------------------------------------------- prefill / decode --


def ring_cache_from_kv(k, v, T: int):
    """Pack full-sequence K/V (B,S,KV,hd) into a slot cache of length T.

    T ≥ S: plain pad. T < S (sliding window): slot s keeps the latest
    position p < S with p ≡ s (mod T) — the ring layout decode writes into.
    Returns (k_cache, v_cache, slot_pos (B,T) int32, −1 = empty).
    """
    B, S = k.shape[:2]
    dev = k.device
    if T >= S:
        kc = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, T - S))
        vc = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, T - S))
        sp = torch.cat([torch.arange(S, dtype=torch.int32, device=dev),
                        torch.full((T - S,), -1, dtype=torch.int32,
                                   device=dev)])
    else:
        slots = torch.arange(T, dtype=torch.int32, device=dev)
        p = (S - 1) - torch.remainder(S - 1 - slots, T)
        kc = k[:, p.long()]
        vc = v[:, p.long()]
        sp = p
    return kc, vc, sp.expand(B, T).to(torch.int32).contiguous()


def prefill(cfg: ArchConfig, params, batch, cache_len: int):
    """Full-sequence forward that also builds the decode cache. Returns
    (logits of the last position (B,1,V) f32, cache)."""
    dtype = ll.dtype_of(cfg.dtype)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_inputs(cfg, params, batch, dtype)
    pos = _positions(cfg, batch, B, S, x.device)
    T = min(cfg.window, cache_len) if cfg.window else cache_len

    if cfg.block == "xlstm":
        x, cache = xlstm_apply(cfg, params, x)
    else:
        layers = []
        for i in range(cfg.n_layers):
            p_l = layer(params["blocks"], i)
            h = _norm(cfg, p_l, "ln1", x)
            q, k, v = _project_qkv(cfg, p_l["attn"], h, pos)
            a = _attend(cfg, p_l["attn"], q, k, v, B, S)
            kc, vc, sp = ring_cache_from_kv(k, v, T)
            cl = {"k": kc, "v": vc, "slot_pos": sp}
            if cfg.block == "hymba":
                s, cl["ssm_h"] = ssm_mod.mamba_head(
                    h, p_l["ssm"], state=cfg.ssm_state, chunk=cfg.ssm_chunk)
                x = _mix(p_l, x, a, s)
            else:
                x = x + a
            if "ffn" in p_l:
                y, _ = ffn_apply(cfg, p_l["ffn"], _norm(cfg, p_l, "ln2", x))
                x = x + y
            layers.append(cl)
        cache = {k: torch.stack([cl[k] for cl in layers]) for k in layers[0]}

    x = _out_norm(cfg, params, x)
    return ll.unembed(x[:, -1:], _head(cfg, params)), cache


def init_cache(cfg: ArchConfig, batch_size: int, cache_len: int, *,
               device=None):
    """Empty decode cache on ``device`` (default ``cuda``; ``"meta"`` gives
    shapes without storage)."""
    dev = resolve_device(device)
    B = batch_size
    if cfg.block == "xlstm":
        return _xlstm_carry(cfg, B, dev)
    KV, hd = cfg.n_kv_heads, cfg.hd
    dtype = ll.dtype_of(cfg.dtype)
    T = min(cfg.window, cache_len) if cfg.window else cache_len
    L = cfg.n_layers
    cache = {
        "k": torch.zeros((L, B, T, KV, hd), dtype=dtype, device=dev),
        "v": torch.zeros((L, B, T, KV, hd), dtype=dtype, device=dev),
        "slot_pos": torch.full((L, B, T), -1, dtype=torch.int32, device=dev),
    }
    if cfg.block == "hymba":
        cache["ssm_h"] = torch.zeros((L, B, cfg.d_model, cfg.ssm_state),
                                     dtype=_F32, device=dev)
    return cache


def decode_step(cfg: ArchConfig, params, cache, tokens, pos):
    """One decode step. tokens (B,1) int32; pos an int (or 0-d tensor).

    Returns (logits (B,1,V) f32, cache). The attention caches (``k``,
    ``v``, ``slot_pos``, and Hymba's ``ssm_h``) are updated IN PLACE and
    the same dict is returned; xLSTM returns a new carry. Do not reuse the
    cache passed in as the state before this step.
    """
    pos = int(pos)
    dtype = ll.dtype_of(cfg.dtype)
    B = tokens.shape[0]
    x = ll.embed(tokens, params["embed"], dtype)
    if cfg.block == "xlstm":
        x, cache = xlstm_apply(cfg, params, x, carry=cache, step=True)
    else:
        shape = (B, 1, 3) if cfg.rope == "mrope" else (B, 1)
        pos_arr = torch.full(shape, pos, dtype=torch.int32, device=x.device)
        for i in range(cfg.n_layers):
            cache_l = layer(cache, i)
            x, cl, _ = block_apply(cfg, layer(params["blocks"], i), x,
                                   pos_arr, cache_l=cache_l, decode_pos=pos)
            for k, u in cl.items():
                if u is not cache_l[k]:
                    cache[k][i] = u
    x = _out_norm(cfg, params, x)
    return ll.unembed(x, _head(cfg, params)), cache
