"""Qwen1.5-4B [hf:Qwen/Qwen1.5-4B] — QKV bias."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    num_layers=40, d_model=2560, num_heads=20, num_kv_heads=20,
    d_ff=6912, vocab_size=151936, head_dim=128,
    block_pattern=("attn",), qkv_bias=True, rope_theta=5e6,
)
