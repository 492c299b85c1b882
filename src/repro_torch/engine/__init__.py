"""The pricing engine: one profile -> solve -> argmin pipeline.

Every session builds a :class:`PriceTable` and hands it to a
:class:`PricingEngine`; interchangeable executors —
:class:`~repro_torch.engine.host.HostExecutor` (golden reference, plain
torch) and :class:`~repro_torch.engine.device.DeviceExecutor` (the CUDA
``price_grid`` kernel) — do the solving.
"""
from repro_torch.engine.host import HostExecutor
from repro_torch.engine.table import PriceSolution, PriceTable, PricingEngine

__all__ = ["PriceTable", "PriceSolution", "PricingEngine", "HostExecutor",
           "DeviceExecutor"]


def __getattr__(name):
    # DeviceExecutor pulls in the kernel wrappers; keep it lazy so
    # host-only use never touches kernels at import time.
    if name == "DeviceExecutor":
        from repro_torch.engine.device import DeviceExecutor
        return DeviceExecutor
    raise AttributeError(name)
