"""MusicGen-Large decoder backbone over EnCodec tokens [arXiv:2306.05284; hf].

Backbone-only per assignment: the EnCodec frontend is external; the LM input
is the discrete code stream (vocab 2048).  Classic (non-gated) transformer FFN.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=2048, head_dim=64,
    block_pattern=("attn",), mlp_gated=False,
)
