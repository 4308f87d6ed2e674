"""Cross-process transfer between serving tiers: the ``StageLink``
transport (``link.py``, torch-free) and disaggregated prefill/decode
serving over it (``disagg.py``, the worker side, which imports torch)."""
