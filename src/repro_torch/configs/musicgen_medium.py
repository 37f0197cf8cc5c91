"""musicgen-medium [audio] — decoder-only over EnCodec tokens; the
mel-spectrogram/EnCodec conv frontend is a STUB: input_specs() provides
precomputed frame embeddings (B, S, d_model) [arXiv:2306.05284]."""
from ..models.transformer.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=6144, vocab_size=2048, input_mode="embeds",
    source="arXiv:2306.05284",
)
