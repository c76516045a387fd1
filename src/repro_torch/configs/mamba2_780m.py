"""Mamba-2 780M [arXiv:2405.21060] — SSD, attention-free.

d_inner = 2*d_model = 3072, head_dim 64 -> 48 SSD heads, state 128, conv 4.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=50280, head_dim=64,
    block_pattern=("ssd",), ssm_state=128, ssm_conv=4, ssm_expand=2,
    ssm_head_dim=64, ssm_chunk=256, tie_embeddings=True,
)
