"""repro_torch.data — the DDM workload registry (:mod:`.synthetic`)."""
from repro_torch.data.synthetic import DDM_WORKLOADS, ddm_workload

__all__ = ["DDM_WORKLOADS", "ddm_workload"]
