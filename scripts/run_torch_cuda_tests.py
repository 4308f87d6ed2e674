#!/usr/bin/env python3
"""Run the port's ``cuda``-marked tests on a machine that has a GPU and no
JAX.

    python3 scripts/run_torch_cuda_tests.py [pytest arguments]

The port's test files compare it with the JAX package, so they (and
``tests/conftest.py``) import ``jax``, ``flax`` and
``distributed_pipeline_tpu`` at module level. The tests marked ``cuda``
never call those: they hold a CUDA kernel against its plain PyTorch
version. This runner installs an import hook that answers every import of
those packages with an inert stand-in module, then runs pytest on the
port's test files with ``-m cuda``, so only the kernel tests run. It exits
with pytest's code, and with 1 when CUDA is not available (the tests would
only skip). Extra arguments go to pytest after the defaults (for example
``-k span`` or a narrower file list).
"""

from __future__ import annotations

import glob
import importlib.abc
import importlib.machinery
import os
import sys
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the packages only the reference side of the tests imports
STUBBED = ("jax", "jaxlib", "flax", "optax", "orbax",
           "distributed_pipeline_tpu")


class _Inert:
    """Stands in for any object of a stubbed package: every attribute,
    call, item and iteration gives another stand-in (or nothing)."""

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return _Inert()

    def __call__(self, *args, **kwargs):
        return _Inert()

    def __getitem__(self, key):
        return _Inert()

    def __iter__(self):
        return iter(())


class _StubModule(types.ModuleType):
    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        full = f"{self.__name__}.{name}"
        if full in sys.modules:
            return sys.modules[full]
        return _Inert()


class _StubFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in STUBBED:
            return importlib.machinery.ModuleSpec(name, self,
                                                  is_package=True)
        return None

    def create_module(self, spec):
        module = _StubModule(spec.name)
        module.__path__ = []
        return module

    def exec_module(self, module):
        parent, _, child = module.__name__.rpartition(".")
        if parent and parent in sys.modules:
            setattr(sys.modules[parent], child, module)


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("run_torch_cuda_tests: CUDA is not available; the cuda "
              "tests would only skip", file=sys.stderr)
        return 1
    sys.meta_path.insert(0, _StubFinder())
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    import pytest
    files = sorted(glob.glob(os.path.join("tests", "test_torch_port_*.py")))
    return int(pytest.main(["-m", "cuda", "-q", "-p", "no:cacheprovider",
                            "-p", "no:randomly", *files, *argv]))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
