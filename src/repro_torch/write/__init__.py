"""Write-path cost modeling: delta staging, merge scheduling, WriteSession.

The write-side counterpart of ``repro_torch.serving``: ingest a live read/write
trace, stage mutations in a memory-resident delta buffer, and decide WHEN
to merge the delta into the base structure by pricing the alternatives
through the CAM engine — deferring a merge shrinks the buffer pool (the
delta steals cache pages, so probe misses rise), merging now pays the
merge's own sorted-burst I/O.  ``scheduler.CamMergeScheduler`` answers the
question with Eq. 15 extended over a decision horizon; ``WriteSession``
drives it end-to-end and accounts both I/O streams.
"""
from repro_torch.write.delta import DeltaBuffer, merge_burst_workload
from repro_torch.write.scheduler import (CamMergeScheduler, DecisionContext,
                                   EveryKScheduler, MergeDecision,
                                   OnFullScheduler)
from repro_torch.write.session import (BatchRecord, WriteConfig, WriteSession,
                                 WriteSessionReport)

__all__ = [
    "DeltaBuffer", "merge_burst_workload",
    "CamMergeScheduler", "EveryKScheduler", "OnFullScheduler",
    "MergeDecision", "DecisionContext",
    "WriteConfig", "WriteSession", "WriteSessionReport", "BatchRecord",
]
