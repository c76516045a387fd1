"""MiniCPM-2B [arXiv:2404.06395; hf] — llama-like, tied embeddings, WSD schedule
(the schedule lives in the training recipe: OptConfig(schedule="wsd"))."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
    d_ff=5760, vocab_size=122753, head_dim=64,
    block_pattern=("attn",), tie_embeddings=True,
)

OPT_SCHEDULE = "wsd"
