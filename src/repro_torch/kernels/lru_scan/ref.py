"""Sequential oracle for the gated linear recurrence, the port of
``repro/kernels/lru_scan/ref.py``."""

import torch


def lru_scan_ref(a, b):
    """h_t = a_t * h_{t-1} + b_t over axis 1 of [B, S, D]; h_{-1} = 0."""
    a32, b32 = a.float(), b.float()
    h = torch.zeros((a.shape[0], a.shape[2]), dtype=torch.float32,
                    device=a.device)
    hs = []
    for t in range(a.shape[1]):
        h = a32[:, t] * h + b32[:, t]
        hs.append(h)
    out = torch.stack(hs, dim=1) if hs else a32
    return out.to(a.dtype)
