"""Deterministic synthetic data pipeline: the port of
``repro/data/pipeline.py``.

Tokens (and hubert's frame labels) are a hash of (stream seed, step,
position), the JAX package's ``_hash_tokens`` bit for bit, so a restarted
run gets exactly the batches it would have had from the step counter alone.
Frames and patch embeddings are standard normals from a ``torch.Generator``
seeded from ``(seed, step)`` on the batch's device: the JAX package draws
them with threefry (``jax.random.fold_in``), whose numbers PyTorch does not
reproduce, so they are deterministic per (seed, step, device) but not the
JAX package's; the parity tests feed JAX's arrays into both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, NamedTuple

import torch

from ..core.context import resolve_device

_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    seed: int = 0
    frontend: str = "none"           # none | patches | frames
    n_frontend_tokens: int = 0
    d_model: int = 0                 # for frontend embedding stubs


class BatchSpec(NamedTuple):
    """A batch entry's shape and dtype (the JAX ``ShapeDtypeStruct``'s)."""
    shape: tuple
    dtype: torch.dtype


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c`` modulo 2^32 for ``a`` in [0, 2^32) held in int64: uint32
    multiplication, which wraps, done in two 16-bit halves of ``c`` so no
    int64 product overflows."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _hash_tokens(seed: int, step: int, b: int, s: int, vocab: int,
                 device=None) -> torch.Tensor:
    """The JAX package's stateless splitmix-style token generator, its
    uint32 arithmetic in int64 masked to 32 bits after every step:
    ``[b, s]`` int32 tokens below ``vocab``."""
    rows = torch.arange(b, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(s, dtype=torch.int64, device=device)[None, :]
    i = (_mul32(rows, 2654435761) + _mul32(cols, 40503)) & _U32
    i = (i + _mul32(torch.tensor(step & _U32, dtype=torch.int64,
                                 device=device), 374761393)) & _U32
    i = (i + (seed & _U32)) & _U32
    i = _mul32(i ^ (i >> 15), 2246822519)
    i = _mul32(i ^ (i >> 13), 3266489917)
    i = i ^ (i >> 16)
    return (i % vocab).to(torch.int32)


def _normals(cfg: DataConfig, step: int, shape, device) -> torch.Tensor:
    """Standard normals ``shape`` (float32) from a generator on ``device``
    seeded from ``(cfg.seed, step)``."""
    gen = torch.Generator(device=device)
    gen.manual_seed((cfg.seed * 0x9E3779B1 + step) % (1 << 63))
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32)


def synthetic_batch(cfg: DataConfig, step: int,
                    device=None) -> Dict[str, torch.Tensor]:
    """The batch of ``step`` on ``device`` (CUDA unless the caller names
    another; it raises without CUDA): ``frames`` and ``labels`` for the
    frames frontend, else ``tokens`` (after ``patches`` for the patches
    frontend, whose tokens are the ``seq_len`` positions left after them)."""
    device = resolve_device(device)
    b, s = cfg.global_batch, cfg.seq_len
    if cfg.frontend == "frames":
        return {"frames": _normals(cfg, step, (b, s, cfg.d_model), device),
                "labels": _hash_tokens(cfg.seed + 1, step, b, s, cfg.vocab,
                                       device)}
    s_text = s - (cfg.n_frontend_tokens if cfg.frontend == "patches" else 0)
    out = {"tokens": _hash_tokens(cfg.seed, step, b, s_text, cfg.vocab,
                                  device)}
    if cfg.frontend == "patches":
        out["patches"] = _normals(
            cfg, step, (b, cfg.n_frontend_tokens, cfg.d_model), device)
    return out


def synthetic_batches(cfg: DataConfig, start_step: int = 0,
                      device=None) -> Iterator[Dict]:
    """The batches of ``start_step``, ``start_step + 1``, ... on ``device``
    (as :func:`synthetic_batch`): a run resumed at a step gets the batches
    the first run would have had."""
    device = resolve_device(device)
    step = start_step
    while True:
        yield synthetic_batch(cfg, step, device)
        step += 1


def make_batch_specs(cfg: DataConfig,
                     dtype: torch.dtype = torch.bfloat16) -> Dict:
    """The batch's entries as :class:`BatchSpec` (shape and dtype, nothing
    allocated)."""
    b, s = cfg.global_batch, cfg.seq_len
    if cfg.frontend == "frames":
        return {"frames": BatchSpec((b, s, cfg.d_model), dtype),
                "labels": BatchSpec((b, s), torch.int32)}
    s_text = s - (cfg.n_frontend_tokens if cfg.frontend == "patches" else 0)
    out = {"tokens": BatchSpec((b, s_text), torch.int32)}
    if cfg.frontend == "patches":
        out["patches"] = BatchSpec((b, cfg.n_frontend_tokens, cfg.d_model),
                                   dtype)
    return out
