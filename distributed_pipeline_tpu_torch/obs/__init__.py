"""Observability: the per-phase cost ledger (``ledger.py``) and span
tracing (``trace.py``, torch-free)."""
