"""Memory-budgeted index tuning via CAM (paper §V).

``repro_torch.tuning.session`` is the tuning surface: ``TuningSession`` over
declarative ``KnobSpace``s, lazy ``SizeModel``s, and pluggable ``Tuner``
strategies (CAM joint knob x buffer-split search, multicriteria-PGM and
CDFShop cache-oblivious baselines).
"""
from repro_torch.tuning import fit, session

__all__ = ["fit", "session"]
