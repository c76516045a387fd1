"""Architecture registry and assigned input shapes.

Each ``configs/<arch>.py`` exports ``CONFIG`` with the published numbers,
the same data as the reference's ``repro.configs``.  ``input_specs`` and
``batch_axes`` (shape stand-ins for the TPU dry run) come with the
launchers.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

from repro_torch.models.config import ModelConfig

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
