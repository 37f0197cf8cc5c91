"""Plain PyTorch version of the SSD intra-chunk kernel.

The oracle the kernel is held to on the card, the CPU path of the
wrapper, and the ``backend="torch"`` path of ``ssd_chunked``.  It rounds
where the JAX package's Pallas kernel (``ssd_chunk.py:26-51``) rounds,
not where its jnp oracle does: ``dt * A`` in the input dtype, then its
cumsum, the decays, ``C Bᵀ`` and ``M`` in fp32; ``M`` and the weighted
``x`` rounded to the input dtype before their products, which sum in
fp32; both outputs in the input dtype.
"""

from __future__ import annotations

import torch


def ssd_chunk_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Intra-chunk SSD.  x: (BC, Q, H, P); dt: (BC, Q, H) (post-softplus);
    A: (H,); Bm/Cm: (BC, Q, N).

    Returns (y_intra (BC, Q, H, P), state (BC, H, P, N)):
      y_intra[i] = sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) dt_j x_j
      state      = sum_j exp(cum_last - cum_j) dt_j x_j (x) B_j
    with cum the inclusive cumsum of dt·A along the chunk.
    """
    Q = x.shape[1]
    cum = torch.cumsum((dt * A).float(), dim=1)              # (BC, Q, H)
    seg = cum[:, :, None, :] - cum[:, None, :, :]            # (BC, Q, Q, H)
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    # exp(-inf) = 0 above the diagonal, where seg > 0 could overflow
    L = torch.exp(seg.masked_fill(~causal[None, :, :, None], -torch.inf))
    cb = torch.einsum("bin,bjn->bij", Cm.float(), Bm.float())
    M = cb[..., None] * L * dt.float()[:, None, :, :]
    y = torch.einsum("bijh,bjhp->bihp", M.to(x.dtype).float(), x.float())
    decay_tail = torch.exp(cum[:, -1:, :] - cum) * dt.float()   # (BC, Q, H)
    xw = (x.float() * decay_tail[..., None]).to(x.dtype).float()
    st = torch.einsum("bqhp,bqn->bhpn", xw, Bm.float())
    return y.to(x.dtype), st.to(x.dtype)
