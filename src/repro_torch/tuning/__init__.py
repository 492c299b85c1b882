"""Memory-budgeted index tuning via CAM (paper §V).

``repro_torch.tuning.session`` is the tuning surface: ``TuningSession`` over
declarative ``KnobSpace``s, lazy ``SizeModel``s, and pluggable ``Tuner``
strategies (CAM joint knob x buffer-split search, multicriteria-PGM and
CDFShop cache-oblivious baselines).  The per-family modules
(``pgm_tuner`` / ``rmi_tuner`` / ``rs_tuner``) are deprecated shims.
"""
from repro_torch.tuning import fit, pgm_tuner, rmi_tuner, rs_tuner, session

__all__ = ["fit", "pgm_tuner", "rmi_tuner", "rs_tuner", "session"]
