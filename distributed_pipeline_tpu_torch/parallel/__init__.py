"""Process supervision: the supervised one-process worker ring
(``launcher.py``) the serving fleet runs each replica under. Torch-free."""
