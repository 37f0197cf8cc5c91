"""Architecture configs for the assigned-architecture pool (a copy of the
JAX package's ``models/transformer/config.py``; pure Python).

Every config cites its source model card / paper.  ``layer_pattern``
selects the mixer per layer: 'attn' (transformer block), 'mamba'
(Mamba2/SSD block).  ``shared_attn_every`` > 0 inserts a *shared* (one
weight set) attention+MLP block after every k-th layer (Zamba2).
"""

from __future__ import annotations

from dataclasses import dataclass, replace


def _pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclass(frozen=True)
class ArchConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int                 # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    qkv_bias: bool = False
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    # structure
    layer_pattern: str = "attn"      # 'attn' | 'mamba'
    shared_attn_every: int = 0       # Zamba2: shared block cadence
    sliding_window: int = 0          # 0 = full (global) attention
    input_mode: str = "tokens"       # 'tokens' | 'embeds' (vlm/audio stubs)
    family: str = "dense"            # dense|moe|ssm|hybrid|vlm|audio
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    source: str = ""

    # ---- derived ----
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def vocab_padded(self) -> int:
        """Embedding table padded so the vocab axis shards over 'model'
        (multiple of 512; logits at padded slots are masked)."""
        return _pad_to(self.vocab_size, 512)

    @property
    def is_ssm(self) -> bool:
        return self.layer_pattern == "mamba"

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM state or a finite attention window."""
        return self.is_ssm or self.sliding_window > 0

    def with_sliding_window(self, window: int) -> "ArchConfig":
        """Sliding-window variant used by pure full-attention archs for
        the long_500k shape (see DESIGN.md §4)."""
        return replace(self, sliding_window=window,
                       name=f"{self.name}-swa{window}")

    def reduced(self, n_layers: int = 2, d_model: int | None = None,
                n_experts: int | None = None) -> "ArchConfig":
        """Smoke-test variant: <=2 layers, d_model<=512, <=4 experts."""
        d = min(self.d_model, d_model or 256)
        # keep head structure but shrink: head_dim <= 64
        if self.n_heads:
            heads = max(2, min(self.n_heads, 4))
            kv = max(1, min(self.n_kv_heads, heads))
            hd = max(8, min(64, d // heads))
        else:
            heads = kv = hd = 0
        ne = min(self.n_experts, 4 if n_experts is None else n_experts)
        return replace(
            self,
            name=f"{self.name}-smoke",
            n_layers=n_layers,
            d_model=d,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 2 * d) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 1024),
            n_experts=ne,
            moe_top_k=min(self.moe_top_k, max(1, ne // 2)) if ne else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            shared_attn_every=2 if self.shared_attn_every else 0,
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window else 0,
        )

    def param_count(self) -> int:
        """Approximate parameter count (for 6·N·D roofline sanity)."""
        d, L = self.d_model, self.n_layers
        total = self.vocab_size * d  # embedding
        per = 0
        if self.layer_pattern == "attn":
            per += d * self.n_heads * self.hd + 2 * d * self.n_kv_heads * self.hd
            per += self.n_heads * self.hd * d
            if self.is_moe:
                per += self.n_experts * 3 * d * self.d_ff + d * self.n_experts
            else:
                per += 3 * d * self.d_ff
        else:  # mamba
            di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
            per += d * (2 * di) + 2 * d * N + d * H  # in projections
            per += di * self.ssm_conv + di * d       # conv + out proj
        total += L * per
        if self.shared_attn_every:
            sd = d
            total += (sd * self.n_heads * self.hd
                      + 2 * sd * self.n_kv_heads * self.hd
                      + self.n_heads * self.hd * sd + 3 * sd * self.d_ff)
        total += self.vocab_size * d  # output head
        return total

    def active_param_count(self) -> int:
        if not self.is_moe:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        inactive = L * (self.n_experts - self.moe_top_k) * 3 * d * self.d_ff
        return self.param_count() - inactive
