"""Phi-3-Vision 4.2B [hf:microsoft/Phi-3-vision-128k-instruct].

phi3-mini backbone + CLIP ViT-L/14-336 frontend STUB: input_specs ships 577
precomputed patch embeddings (576 patches + CLS) projected to d_model.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32064, head_dim=96,
    block_pattern=("attn",), ext_embed_len=577, rope_theta=1e4,
)
