"""Children for the port's crash-recovery tests: each runs
``psrs_run_recoverable`` of one package on a fixed dataset in a fresh
interpreter, so that ``kill -9`` (the runner's ``crash_in_stage``/
``crash_after_stage`` hooks, or an injected ``kill`` fault) ends that child
alone, and the next child resumes from the state dir it left.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import textwrap

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {"PYTHONPATH": os.pathsep.join([os.path.join(REPO, "src"),
                                      os.path.join(REPO, "tests")]),
       "PATH": "/usr/bin:/bin:/usr/local/bin",
       "JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS", "cpu")}
N_STAGES = 8        # "load" + the seven psrs_plan stages
N, V, K = 1024, 4, 2


def keys() -> np.ndarray:
    """The one dataset every child sorts: a resumed run must give exactly
    the bytes an uninterrupted run gives."""
    return np.random.default_rng(17).integers(-2**31, 2**31 - 1, size=N,
                                              dtype=np.int32)


# argv: package, state_dir, io_driver, kind (in/after/none), stage,
# fault_spec, P, tier, device (the port's)
_CHILD = textwrap.dedent("""
    import sys
    import numpy as np
    import _chaos

    pkg, state_dir, io_driver, kind, stage, fault_spec, P, tier, dev = \
        sys.argv[1:10]
    stage = int(stage) if stage.isdigit() else stage
    if pkg == "jax":
        import _jax_ref
        run, kw = _jax_ref.apps.psrs_run_recoverable, {}
    else:
        from repro_torch.pems_apps import psrs_run_recoverable as run
        kw = {"device": dev}
    data = _chaos.keys()
    out = run(
        data, v=_chaos.V, k=_chaos.K, P=int(P), state_dir=state_dir,
        tier=tier, io_driver=(
            None if tier != "file" else
            ("faulty:" + io_driver) if fault_spec else io_driver),
        fault_spec=fault_spec or None, io_queue_depth=4,
        crash_in_stage=stage if kind == "in" else None,
        crash_after_stage=stage if kind == "after" else None, **kw)
    np.testing.assert_array_equal(np.asarray(out), np.sort(data))
    print("CHAOS_OK")
""")


def run_child(state_dir, io_driver="buffered", kind="none", stage=0,
              fault_spec="", pkg="port", P=1, tier="file", device="cpu"):
    """One child of package ``pkg`` (``"port"`` or ``"jax"``); ``stage`` is
    an index or a stage name; the port's stages run on ``device``."""
    return subprocess.run(
        [sys.executable, "-c", _CHILD, pkg, str(state_dir), io_driver, kind,
         str(stage), fault_spec, str(P), tier, device],
        capture_output=True, text=True, timeout=600, env=ENV, cwd=REPO)


def assert_killed(r) -> None:
    assert r.returncode == -signal.SIGKILL, (r.returncode, r.stderr[-3000:])


def assert_ok(r) -> None:
    assert "CHAOS_OK" in r.stdout, (r.returncode, r.stderr[-3000:])


def kill_chain(state_dir, io_driver: str, kind: str, stages) -> None:
    """Kill a child in (or after) each stage in turn on one state dir, each
    resuming the one before; then a child completes the run."""
    for stage in stages:
        assert_killed(run_child(state_dir, io_driver, kind=kind, stage=stage))
        assert os.path.exists(os.path.join(state_dir, "cursor.json"))
    assert_ok(run_child(state_dir, io_driver))
