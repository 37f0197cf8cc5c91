"""mixtral-8x7b [moe] — 8 experts top-2, native sliding-window attention
[arXiv:2401.04088]."""
from ..models.transformer.config import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    n_experts=8, moe_top_k=2, sliding_window=4096,
    source="arXiv:2401.04088",
)
