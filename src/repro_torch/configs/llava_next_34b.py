"""llava-next-34b [vlm] — anyres tiling; the ViT/SigLIP vision encoder +
projector are STUBS: input_specs() provides precomputed patch embeddings
(B, S, d_model) and this config is the language backbone
[hf:llava-hf/llava-v1.6-mistral-7b-hf]."""
from ..models.transformer.config import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab_size=64000, input_mode="embeds",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
