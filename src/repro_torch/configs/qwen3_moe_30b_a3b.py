"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B] — 128 experts top-8, every layer MoE,
per-expert FFN hidden 768, GQA kv=4."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=768, vocab_size=151936, head_dim=128,
    block_pattern=("attn_moe",),
    num_experts=128, experts_per_token=8, moe_d_ff=768, shared_expert=False,
    capacity_factor=1.25, rope_theta=1e6,
)
