"""CAM core: the paper's contribution as a composable PyTorch module."""
from repro_torch.core import (cache_models, cam, dac, device_models, page_ref,
                              qerror, replay, session, workload)

__all__ = [
    "cache_models",
    "cam",
    "dac",
    "device_models",
    "page_ref",
    "qerror",
    "replay",
    "session",
    "workload",
]
