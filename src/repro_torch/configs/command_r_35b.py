"""command-r-35b [dense] — GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01]."""
from ..models.transformer.config import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22528, vocab_size=256000,
    source="hf:CohereForAI/c4ai-command-r-v01",
)
