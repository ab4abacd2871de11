"""AdamW with optional int8-quantized moments: the port of
``repro/optim/adamw.py``.

The int8 variant stores m and v as int8 with a float32 absmax scale per
block of ``block`` elements along the last dim (shape-preserving, as the
JAX package does); :func:`_quant` and :func:`_dequant` give its bits
(``torch.round`` rounds half to even, as ``jnp.round`` does).

Unlike the JAX package, whose update returns new arrays, the port updates
the parameters and the moments **in place**: at full width (hubert-xlarge's
0.95 G parameters, qwen2-1.5b's 1.54 G) a second copy of the parameters
and of two float32 moments would not fit beside the model.  ``scan_stacked``
is accepted and moot: the port's layers are one dict each already, so the
float32 transients exist for one leaf at a time.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..tree import leaves, map_tree


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantize_moments: bool = False   # int8 m/v (for the giant MoE configs)
    block: int = 2048                # quantization block size
    scan_stacked: bool = False       # accepted for the JAX signature; moot
    scan_min_dim: int = 8


def adamw_init(params, cfg: OptConfig) -> Dict:
    """``{"step", "m", "v"}``: step 0 (int32) and zero moments of the
    parameters' shapes (float32, or int8 blocks with their scales)."""
    dev = next(leaves(params)).device

    def moment(p):
        if cfg.quantize_moments:
            last = p.shape[-1] if p.ndim else 1
            nb = -(-last // cfg.block)
            return {"q": torch.zeros(p.shape, dtype=torch.int8,
                                     device=p.device),
                    "scale": torch.zeros(p.shape[:-1] + (nb,),
                                         dtype=torch.float32,
                                         device=p.device)}
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": map_tree(moment, params), "v": map_tree(moment, params)}


def _blocked(x: torch.Tensor, block: int):
    last = x.shape[-1]
    nb = -(-last // block)
    pad = nb * block - last
    if pad:
        x = F.pad(x, (0, pad))
    return x.reshape(x.shape[:-1] + (nb, block)), last


def _dequant(q: Dict, shape, block: int) -> torch.Tensor:
    qb, last = _blocked(q["q"].float(), block)
    x = qb * q["scale"][..., None] / 127.0
    x = x.reshape(x.shape[:-2] + (-1,))[..., :last]
    return x.reshape(shape)


def _quant(x: torch.Tensor, block: int) -> Dict:
    xb, last = _blocked(x, block)
    scale = xb.abs().amax(dim=-1)
    safe = torch.where(scale == 0.0, 1.0, scale)
    qb = torch.clamp(torch.round(xb / safe[..., None] * 127.0), -127, 127)
    q = qb.reshape(qb.shape[:-2] + (-1,))[..., :last].reshape(x.shape)
    return {"q": q.to(torch.int8), "scale": scale}


@torch.no_grad()
def adamw_update(params, grads, state: Dict, cfg: OptConfig,
                 lr_scale=1.0) -> Tuple[Dict, Dict, Dict]:
    """One AdamW step: the global-norm clip, bias correction, and weight
    decay on every leaf.  Updates ``params`` and ``state``'s moments and
    step in place and returns ``(params, state, {"gnorm", "lr"})``."""
    step = state["step"] + 1
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=step.device)

    # Global-norm gradient clip, the squares summed leaf by leaf in the
    # JAX package's leaf order.
    gsq = sum((g.float() ** 2).sum() for g in leaves(grads))
    gnorm = torch.sqrt(gsq)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)

    bc1 = 1.0 - cfg.b1 ** step.float()
    bc2 = 1.0 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * clip
        if cfg.quantize_moments:
            m_f = _dequant(m, p.shape, cfg.block)
            v_f = _dequant(v, p.shape, cfg.block)
        else:
            m_f, v_f = m, v
        m_f = cfg.b1 * m_f + (1 - cfg.b1) * g
        v_f = cfg.b2 * v_f + (1 - cfg.b2) * g * g
        delta = (m_f / bc1) / (torch.sqrt(v_f / bc2) + cfg.eps) + (
            cfg.weight_decay * p.float())
        p.copy_(p.float() - lr * delta)
        for old, new in ((m, m_f), (v, v_f)):
            if cfg.quantize_moments:
                got = _quant(new, cfg.block)
                old["q"].copy_(got["q"])
                old["scale"].copy_(got["scale"])
            else:
                old.copy_(new)

    map_tree(upd, params, grads, state["m"], state["v"])
    state["step"].copy_(step)
    return params, state, {"gnorm": gnorm, "lr": lr}
