"""Chaos matrix of the port under the ``odirect`` I/O driver: PSRS on the file
tier killed (``kill -9``, in port children) in and after every stage, each
child resuming the one before, then a bit-identical completion
(``tests/test_torch_chaos.py`` runs the buffered driver)."""

from __future__ import annotations

import pytest

from _chaos import kill_chain


@pytest.mark.parametrize("kind", ["in", "after"])
def test_kill9_at_every_stage_then_resume(tmp_path, kind):
    kill_chain(str(tmp_path / "state"), "odirect", kind, range(8))
