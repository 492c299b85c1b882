"""Learned-index substrate: ε-PLA, PGM, RMI, RadixSpline, disk layout,
and the IndexModel adapters that plug every family into CostSession."""
from repro_torch.index import (adapters, disk_layout, pgm, pla, radixspline,
                               rmi)

__all__ = ["adapters", "disk_layout", "pgm", "pla", "radixspline", "rmi"]
