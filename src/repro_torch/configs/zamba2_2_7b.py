"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242]."""
from ..models.transformer.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32000, layer_pattern="mamba",
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
    shared_attn_every=6,     # 9 shared-block applications over 54 layers
    source="arXiv:2411.15242",
)
