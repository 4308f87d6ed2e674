"""Observability: the per-phase cost ledger (``ledger.py``)."""
