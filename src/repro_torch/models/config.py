"""Unified model configuration for the architecture zoo.

The fields, defaults and derived numbers are the reference's
(``repro.models.config``); ``act_dtype`` and ``w_dtype`` give torch dtypes.
``q_chunk``, ``attn_impl`` and ``ssd_impl`` keep their meaning: ``attn_impl
="flash"`` runs the hand-written flash-attention kernel on a CUDA tensor
and ``ssd_impl="kernel"`` the SSD scan kernel.  ``remat`` selects the
activation checkpointing of a train-mode forward
(``models.transformer``).  ``scan_layers`` changes
nothing and no code of the port reads it.  The MoE sharding switches
(``moe_seq_shard``, ``moe_expert_resident``) act only under a mesh with a
``model`` axis (``models/moe.py``), as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(_DTYPES)}") from None


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # block pattern: the repeating unit scanned over; remainder layers are
    # unrolled.  kinds: attn | attn_moe | attn_local | ssd | rglru
    block_pattern: tuple[str, ...] = ("attn",)

    norm_eps: float = 1e-5
    qkv_bias: bool = False
    mlp_gated: bool = True
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    attn_window: int = 0             # for attn_local blocks
    attn_logit_softcap: float = 0.0

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim (0 -> d_ff)
    shared_expert: bool = False
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256

    # hybrid (RG-LRU)
    lru_width: int = 0               # 0 -> d_model

    # modality frontend stub (audio/vlm): number of external embedding slots
    # prepended to the token sequence; input_specs ships them precomputed.
    ext_embed_len: int = 0

    # numerics / compilation
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: str = "block"             # none | block | dots
    scan_layers: bool = True
    q_chunk: int = 2048              # q-block size for chunked attention
    attn_impl: str = "naive"         # naive | fused (flash-style) | flash (Pallas)
    ssd_impl: str = "xla"            # xla | kernel (Pallas ssd_scan)
    moe_seq_shard: bool = False      # shard_map MoE input seq-sharded (SP-lite)
    moe_expert_resident: bool = False  # expert weights resident (E x F over
    #   model x data); tokens travel to them — no FSDP gather for experts

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ---- derived ----
    @property
    def act_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def w_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def n_super(self) -> int:
        return self.num_layers // len(self.block_pattern)

    @property
    def trailing(self) -> tuple[str, ...]:
        r = self.num_layers % len(self.block_pattern)
        return self.block_pattern[:r]

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        """Each layer's block kind, first to last."""
        return tuple(self.block_pattern) * self.n_super + tuple(self.trailing)

    @property
    def group_size(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def d_inner(self) -> int:        # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def rnn_width(self) -> int:
        return self.lru_width or self.d_model

    @property
    def moe_hidden(self) -> int:
        return self.moe_d_ff or self.d_ff

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    # ------------------------------------------------------------------
    # Parameter counts (for MODEL_FLOPS = 6 N D and memory-fit analysis)

    def param_counts(self) -> dict[str, float]:
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        H, Kv, hd = self.num_heads, self.num_kv_heads, self.head_dim

        def attn_params():
            qkv = D * (H + 2 * Kv) * hd + (H + 2 * Kv) * hd * (1 if self.qkv_bias else 0)
            return qkv + H * hd * D

        def mlp_params(hidden):
            return D * hidden * (3 if self.mlp_gated else 2)

        def moe_params():
            e = self.num_experts * mlp_params(self.moe_hidden)
            if self.shared_expert:
                e += mlp_params(self.moe_hidden)
            e += D * self.num_experts  # router
            return e

        def ssd_params():
            di, ds, nh = self.d_inner, self.ssm_state, self.ssm_heads
            in_proj = D * (2 * di + 2 * ds + nh)
            conv = self.ssm_conv * (di + 2 * ds)
            out = di * D
            extra = nh * 3  # A, D, dt_bias
            return in_proj + conv + out + extra + di  # + gate norm

        def rglru_params():
            w = self.rnn_width
            return D * w * 2 + 4 * w + w * D + 2 * w * w  # in/out proj + gates + conv-ish

        kind_cost = {
            "attn": attn_params() + mlp_params(F),
            "attn_local": attn_params() + mlp_params(F),
            "attn_moe": attn_params() + moe_params(),
            "ssd": ssd_params(),
            "rglru": rglru_params() + mlp_params(F),
        }
        layers = self.layer_kinds
        total_blocks = sum(kind_cost[k] for k in layers)
        embed = V * D * (1 if self.tie_embeddings else 2)
        total = total_blocks + embed + D  # final norm

        # active params (MoE: only top-k experts per token)
        active_blocks = 0.0
        for k in layers:
            if k == "attn_moe":
                a = attn_params() + self.experts_per_token * mlp_params(self.moe_hidden)
                if self.shared_expert:
                    a += mlp_params(self.moe_hidden)
                a += D * self.num_experts
                active_blocks += a
            else:
                active_blocks += kind_cost[k]
        active = active_blocks + embed + D
        return {"total": float(total), "active": float(active)}
