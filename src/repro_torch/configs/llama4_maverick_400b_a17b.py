"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4-Maverick-17B-128E].

Interleaved MoE (every 2nd layer; Maverick's layout) + shared expert,
128 routed experts top-1; GQA kv=8.  See DESIGN.md §6 for the param-count
reconciliation to ~400B total / ~17B active.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    block_pattern=("attn", "attn_moe"),
    num_experts=128, experts_per_token=1, moe_d_ff=8192, shared_expert=True,
    capacity_factor=1.25, rope_theta=5e5,
)
