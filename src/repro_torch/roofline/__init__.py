"""Roofline analysis of the dry run's counts (``repro/roofline``)."""
from repro_torch.roofline.analysis import (H100, V5E, RooflineReport,
                                           collective_bytes,
                                           collective_bytes_of,
                                           roofline_terms)

__all__ = ["collective_bytes", "collective_bytes_of", "roofline_terms",
           "RooflineReport", "V5E", "H100"]
