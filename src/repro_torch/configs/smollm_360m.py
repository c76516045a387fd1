"""SmolLM-360M [hf:HuggingFaceTB/SmolLM-360M] — llama-arch small, GQA kv=5."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    num_layers=32, d_model=960, num_heads=15, num_kv_heads=5,
    d_ff=2560, vocab_size=49152, head_dim=64,
    block_pattern=("attn",), tie_embeddings=True,
)
