"""Sequential oracle for the SSD recurrence, the port of
``repro/kernels/ssd_scan/ref.py``."""

import torch


def ssd_scan_ref(x, dt, A, Bm, Cm):
    """x [B,H,S,P], dt [B,H,S], A [H], Bm/Cm [B,S,N] → y [B,H,S,P]."""
    bsz, h, s, p = x.shape
    n = Bm.shape[-1]
    x32, dt32, A32 = x.float(), dt.float(), A.float()
    B32, C32 = Bm.float(), Cm.float()
    S = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        xt = x32[:, :, t]                        # [B, H, P]
        dtt = dt32[:, :, t]                      # [B, H]
        decay = torch.exp(A32[None, :] * dtt)    # [B, H]
        S = decay[..., None, None] * S + (
            dtt[..., None, None] * B32[:, t][:, None, :, None]
            * xt[:, :, None, :])                 # [B, H, N, P]
        ys.append(torch.einsum("bn,bhnp->bhp", C32[:, t], S))
    y = torch.stack(ys, dim=2) if ys else x32.new_zeros((bsz, h, 0, p))
    return y.to(x.dtype)
