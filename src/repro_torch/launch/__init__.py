"""Entry points of the port (``repro/launch``; only ``serve`` so far)."""
