"""qwen1.5-0.5b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B]."""
from ..models.transformer.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=2816, vocab_size=151936, qkv_bias=True,
    source="hf:Qwen/Qwen1.5-0.5B",
)
