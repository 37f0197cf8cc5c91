"""mamba2-370m [ssm] — SSD (state-space duality) [arXiv:2405.21060]."""
from ..models.transformer.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=50280, layer_pattern="mamba",
    ssm_state=128, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
    source="arXiv:2405.21060",
)
