"""Stand-in MPMD stage worker for the port's pipeline-runtime tests (no
torch import): the port's twin of ``tests/_mpmd_child.py``.

Runs the REAL :class:`~distributed_pipeline_tpu_torch.mpmd.stage_worker.
StageWorker` — same command loop, schedule execution, link framing, epoch
fencing, snapshot/rewind handling, beacons, goodput booking and sidecar
— with its one torch-side seam stubbed through ``sys.modules`` before
construction: ``StageMath`` (imported lazily inside
``StageWorker.__init__``) becomes the JAX fixture's scalar linear chain
(``tests/_mpmd_child.FakeStageMath``, numpy only), with the port's
``stats()`` added. So the driver, protocol and transport layers get full
multi-process end-to-end coverage without a torch import per stage
process, and the tests hold the driver's losses to the JAX fixture's
pure-python reference (``tests/test_mpmd._scalar_chain_reference``).

Argv: --run_dir DIR --stage I --n_stages N   (the StageWorker CLI)
"""

import sys
import types

from tests._mpmd_child import FakeStageMath


class PortFakeStageMath(FakeStageMath):
    """The chain, with the hooks the port's worker calls: the data
    prefetch (the chain's batches are computed) and the sidecar's
    stats."""

    def prefetch(self, step):
        pass

    def stats(self):
        return {"device": "none", "launches": {}, "plain_calls": {},
                "peak_memory_bytes": 0}


def _install_stubs():
    """Shadow the worker's lazy torch-side import. Must run before
    ``StageWorker.__init__``: ``from .stage_math import StageMath``
    resolves through ``sys.modules`` first, so the real module (and
    torch) never loads."""
    sm = types.ModuleType("distributed_pipeline_tpu_torch.mpmd.stage_math")
    sm.StageMath = PortFakeStageMath
    sys.modules["distributed_pipeline_tpu_torch.mpmd.stage_math"] = sm


def main(argv=None) -> int:
    _install_stubs()
    from distributed_pipeline_tpu_torch.mpmd.stage_worker import main as run
    rc = run(argv)
    if "torch" in sys.modules:  # the whole point of this fixture
        print("_torch_port_mpmd_child: torch leaked into the stand-in "
              "worker", file=sys.stderr)
        return 3
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
