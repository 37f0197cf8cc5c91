"""Plain PyTorch version of the SSD intra-chunk kernel.

The oracle the kernel is held to on the card, the CPU path of the
wrapper, and the ``backend="torch"`` path of ``ssd_chunked``.
:func:`ssd_chunk_bwd_ref` is the same for the backward kernel
(``csrc/ssd_chunk_bwd.cu``): its gradients written out as formulas.  It rounds
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


def ssd_chunk_bwd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor,
                      dst: torch.Tensor):
    """Gradients (dx, ddt, dA, dB, dC) of :func:`ssd_chunk_ref` (fp32) for
    the output gradients dy (BC, Q, H, P) and dst (BC, H, P, N), each in
    the shape and dtype of its input.  With cum the inclusive cumsum of
    a = dt·A, L_ij = exp(cum_i − cum_j) for i ≥ j (0 above: the exp is
    taken under the causal mask, so a decay that would overflow above
    the diagonal never enters), M_ij = (C_i·B_j) L_ij dt_j and
    w_j = exp(cum_last − cum_j) dt_j:

      dM_ij = dy_i·x_j;  dx_j = Σ_i M_ij dy_i + w_j (dst B_j);
      dCB_ij = Σ_h dM_ij L_ij dt_j;  dC = dCB B;
      dB = dCBᵀ C + Σ_h w_j (dstᵀ x_j);
      dS = dM M;  dcum_i += Σ_j dS_ij;  dcum_j −= Σ_i dS_ij;
      u_j = x_j·(dst B_j);  dcum_j −= u_j w_j;  dcum_last += Σ_j u_j w_j;
      ddt_j = Σ_i dM_ij (C_i·B_j) L_ij + u_j exp(cum_last − cum_j) + da_j A;
      da = the reverse cumsum of dcum;  dA = Σ da·dt.
    """
    x_, dt_, A_, B_, C_, dy_, dst_ = (t.float() for t in
                                      (x, dt, A, Bm, Cm, dy, dst))
    Q = x.shape[1]
    cum = torch.cumsum(dt_ * A_, dim=1)                       # (BC, Q, H)
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    seg = cum[:, :, None, :] - cum[:, None, :, :]             # (BC, i, j, H)
    L = torch.exp(seg.masked_fill(~causal[None, :, :, None], -torch.inf))
    cb = torch.einsum("bin,bjn->bij", C_, B_)
    cbL = cb[..., None] * L
    M = cbL * dt_[:, None, :, :]
    dM = torch.einsum("bihp,bjhp->bijh", dy_, x_)
    decay = torch.exp(cum[:, -1:, :] - cum)                   # (BC, Q, H)
    w = decay * dt_
    v = torch.einsum("bhpn,bjn->bjhp", dst_, B_)              # dst B_j
    u = (x_ * v).sum(-1)
    dx = torch.einsum("bijh,bihp->bjhp", M, dy_) + w[..., None] * v
    dcb = (dM * L * dt_[:, None, :, :]).sum(-1)               # (BC, i, j)
    dC = torch.einsum("bij,bjn->bin", dcb, B_)
    dB = (torch.einsum("bij,bin->bjn", dcb, C_)
          + torch.einsum("bjh,bhpn,bjhp->bjn", w, dst_, x_))
    dS = dM * M
    uw = u * w
    dcum = dS.sum(2) - dS.sum(1) - uw
    dcum[:, -1] += uw.sum(1)
    da = dcum.flip(1).cumsum(1).flip(1)
    ddt = (dM * cbL).sum(1) + u * decay + da * A_
    dA = (da * dt_).sum((0, 1))
    return tuple(g.to(t.dtype) for g, t in
                 ((dx, x), (ddt, dt), (dA, A), (dB, Bm), (dC, Cm)))
