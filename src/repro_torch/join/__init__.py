"""CAM-guided joins (paper §VI): two-way JoinSession plans + multi-way
JoinTreeSession trees sharing one buffer budget."""
from repro_torch.join import calibrate, executors, hybrid, session, tree
from repro_torch.join.session import (ChooseResult, JoinCostCurve, JoinPlan,
                                JoinSession, JoinStats)
from repro_torch.join.tree import JoinTreeSession, TreePlan, TreeStats

__all__ = ["calibrate", "executors", "hybrid", "session", "tree",
           "JoinSession", "JoinPlan", "JoinStats", "ChooseResult",
           "JoinCostCurve", "JoinTreeSession", "TreePlan", "TreeStats"]
