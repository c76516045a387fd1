"""Architecture registry and assigned input shapes.

Each ``configs/<arch>.py`` exports ``CONFIG`` with the published numbers,
the same data as the reference's ``repro.configs``.  ``input_specs``
builds the ``TensorSpec`` stand-ins (shape and type, no allocation) of a
shape's step inputs, and ``batch_axes`` their logical axes, for
``launch/dryrun.py``.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import TensorSpec

ARCH_IDS = (
    "musicgen_large",
    "internlm2_1_8b",
    "smollm_360m",
    "qwen1_5_4b",
    "minicpm_2b",
    "mamba2_780m",
    "llama4_maverick_400b_a17b",
    "qwen3_moe_30b_a3b",
    "phi3_vision_4_2b",
    "recurrentgemma_2b",
)

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    arch = _ALIASES.get(arch, arch)
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}").CONFIG


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

# families with sub-quadratic sequence handling (bounded state / local window)
SUBQUADRATIC = ("ssm", "hybrid")


def applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    sp = SHAPES[shape]
    if sp.name == "long_500k" and cfg.family not in SUBQUADRATIC:
        return False, "pure full-attention arch: 512k dense KV/attention skipped"
    return True, ""


def input_specs(cfg: ModelConfig, shape: str) -> dict:
    """``TensorSpec`` stand-ins for the step function inputs of ``shape``.

    train/prefill: {"tokens", optional "ext_embed", train adds "labels"}.
    decode: {"tokens" [B,1], "pos" scalar} (the cache comes from
    cache_shapes).
    """
    sp = SHAPES[shape]
    B, S = sp.global_batch, sp.seq_len
    i32 = torch.int32
    if sp.kind == "decode":
        return {"tokens": TensorSpec((B, 1), i32),
                "pos": TensorSpec((), i32)}
    specs: dict = {}
    ext = cfg.ext_embed_len
    specs["tokens"] = TensorSpec((B, S - ext), i32)
    if ext:
        specs["ext_embed"] = TensorSpec((B, ext, cfg.d_model), cfg.act_dtype)
    if sp.kind == "train":
        specs["labels"] = TensorSpec((B, S), i32)
    return specs


def batch_axes(cfg: ModelConfig, shape: str) -> dict:
    """Logical axes for the input specs (mirrors input_specs)."""
    sp = SHAPES[shape]
    if sp.kind == "decode":
        return {"tokens": ("cache_batch", None), "pos": ()}
    ax: dict = {"tokens": ("batch", None)}
    if cfg.ext_embed_len:
        ax["ext_embed"] = ("batch", None, None)
    if sp.kind == "train":
        ax["labels"] = ("batch", None)
    return ax
