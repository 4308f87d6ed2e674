"""Serving settings (argparse over a dataclass)."""
