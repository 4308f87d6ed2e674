"""Continuous-batching serving: paged KV cache, engine, scheduler.

Entry points: ``run/serve.py`` serves a prompt stream through a
:class:`DecodeServer`; ``run/sample.py`` decodes GPT-2 batches through
:func:`one_shot_decode`, the same prefill and decode phases driven as one
lockstep batch. The names below load on first use (the models import
``serving.paged_kv``, so this package must not import the engine while
they load).
"""

import importlib

_LAZY = {
    "DecodeEngine": ".engine",
    "DecodeServer": ".scheduler",
    "one_shot_decode": ".scheduler",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
