"""RecurrentGemma-2B [arXiv:2402.19427; hf] — RG-LRU + local attention, 1:2.

26 layers = 8 x (rglru, rglru, attn_local) + 2 trailing rglru; MQA kv=1,
window 2048, lru_width = d_model.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
    d_ff=7680, vocab_size=256000, head_dim=256,
    block_pattern=("rglru", "rglru", "attn_local"),
    attn_window=2048, lru_width=2560, tie_embeddings=True,
    attn_logit_softcap=0.0,
)
