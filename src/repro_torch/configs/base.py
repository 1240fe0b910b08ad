"""Architecture + workload-shape config system (a copy of the JAX package's
``configs/base.py``: the same fields, values and methods).

Every assigned architecture is an ``ArchConfig`` (one module per arch in this
package); ``reduced()`` derives the CPU smoke-test variant. ``SHAPES`` are
the assigned workload shapes; ``(arch × shape)`` cells drive the multi-pod
dry-run and the roofline table.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | vlm | hybrid | audio | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    # attention
    window: int = 0             # 0 = full causal; >0 = sliding-window size
    qk_norm: bool = False
    rope: str = "rope"          # rope | mrope | none
    rope_theta: float = 10_000.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # block structure
    block: str = "attn"         # attn | hymba | xlstm | encdec
    ssm_state: int = 0          # mamba state size N (hymba)
    slstm_every: int = 0        # xlstm: every k-th layer is sLSTM
    # frontends (stubs fed by input_specs, per assignment)
    frontend: str = "none"      # none | audio | vision
    # numerics / misc
    norm_eps: float = 1e-5
    norm: str = "rms"           # rms | ln
    act: str = "swiglu"         # swiglu | gelu
    tie_embeddings: bool = False
    sub_quadratic: bool = False  # eligible for long_500k decode
    # compute knobs: chunk sizes of attention and the scans
    q_chunk: int = 1024
    kv_chunk: int = 1024
    ssm_chunk: int = 128
    remat: str = "block"        # block | none
    dtype: str = "bfloat16"     # activation/compute dtype

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def reduced(self) -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 2 if self.slstm_every == 0 else
                         max(2, self.slstm_every)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads
            else 4,
            head_dim=16,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab=256,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            window=min(self.window, 32) if self.window else 0,
            ssm_state=min(self.ssm_state, 4) if self.ssm_state else 0,
            q_chunk=16,
            kv_chunk=16,
            ssm_chunk=8,
            dtype="float32",
        )

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, hd = self.d_model, self.hd
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.is_moe:
            ff = self.n_experts * (3 * d * self.d_ff) + d * self.n_experts
        elif self.d_ff:
            mult = 3 if self.act == "swiglu" else 2
            ff = mult * d * self.d_ff
        else:
            ff = 0
        if self.block == "xlstm":
            attn = 0
            ff = 0
            blocks = self.n_layers * (8 * d * d)  # mLSTM proj-heavy estimate
        elif self.block == "hymba":
            ssm = d * 2 * d + d * (2 * self.ssm_state + 1) + 2 * d
            blocks = self.n_layers * (attn + ff + ssm)
        elif self.block == "encdec":
            blocks = self.n_layers * (2 * attn + ff) + \
                (self.n_layers // 2) * attn  # cross-attn on decoder half
        else:
            blocks = self.n_layers * (attn + ff)
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return blocks + emb

    def active_param_count(self) -> int:
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        dense = self.param_count() - self.n_layers * self.n_experts * \
            (3 * d * self.d_ff)
        return dense + self.n_layers * self.top_k * (3 * d * self.d_ff)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the skip reason
    (recorded in the dry-run table, DESIGN.md §6)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("pure full-attention arch: O(S²)/O(S) KV at 524288 is "
                "memory-infeasible; skipped per assignment")
    return None
