"""Batched serving engine: prefill, then greedy or temperature-sampled
decode — the port of ``repro/serve/engine.py``.

PyTorch runs eagerly, so there is no jit; the caches are updated in place
where the JAX engine donates them.  Each :meth:`ServeEngine.generate` records
its prefill time and every decode step's time in :attr:`ServeEngine.timing`:
between CUDA events on the card (read after one synchronise at the end), on
the host clock on the CPU.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch


class ServeEngine:
    def __init__(self, model, max_seq: int):
        self.model = model
        self.max_seq = max_seq
        self.timing: Dict[str, object] = {}

    @torch.inference_mode()
    def generate(self, prompts, steps: int, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Greedy (or, with ``temperature > 0`` and a ``generator``, sampled)
        continuation of a batch of equal-length prompts ``[B, S_prompt]``;
        returns the ``[B, steps]`` generated tokens (int64, on the model's
        device).  ``timing`` then holds ``prefill_ms`` and ``decode_ms``
        (one entry per step)."""
        model = self.model
        prompts = torch.as_tensor(prompts, device=model.device)
        b, s_prompt = prompts.shape
        if s_prompt + steps > self.max_seq:
            raise ValueError(f"{s_prompt} prompt + {steps} generated tokens "
                             f"exceed max_seq={self.max_seq}")
        cache = model.init_cache(b, self.max_seq)
        marks = _Marks(model.device)
        logits, cache = model.prefill({"tokens": prompts}, cache)
        tok = self._pick(logits[:, -1], temperature, generator)
        marks.mark()
        pos = s_prompt
        out = []
        for _ in range(steps):
            out.append(tok)
            logits, cache = model.decode(tok, pos, cache)
            pos += 1
            tok = self._pick(logits[:, -1], temperature, generator)
            marks.mark()
        ms = marks.intervals_ms()
        self.timing = {"prefill_ms": ms[0], "decode_ms": ms[1:]}
        return torch.cat(out, dim=1)

    @staticmethod
    def _pick(logits, temperature, generator):
        if temperature <= 0.0 or generator is None:
            return logits.argmax(dim=-1)[:, None]
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)


class _Marks:
    """Time marks on the device's own clock: CUDA events on the card (no
    synchronise until read), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: List = []
        self.mark()

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> List[float]:
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]
