"""repro_torch.core — the DDM service's matching paths in PyTorch.

Public surface:
  Extents, make_uniform_workload, ...      — containers & paper workloads
  encode_endpoints, sbm_count, ...         — the sort-based sweep (counting)
  sbm_enumerate, enumerate_matches, ...    — pair enumeration + oracles
  enumerate_matches_ddim, bitmatrix_*, ... — d-dim matching (selective
                                             sweep, bit-matrix AND)
  IncrementalIndex, BatchDelta             — persistent index + delta rematch
  DDMService                               — HLA-style service facade
  execute_enumeration, CapacityPolicy, ... — the runtime planner/executor
"""
from repro_torch.core.errors import (
    CapacityError,
    DDMError,
    DeadlineExceeded,
    GridOverflowError,
    KernelError,
    OverloadError,
    ValidationError,
)
from repro_torch.core.intervals import (
    Extents,
    brute_force_count_numpy,
    brute_force_pairs_numpy,
    intersect_1d,
    intersect_ddim,
    make_clustered_workload,
    make_tall_thin_workload,
    make_uniform_workload,
)
from repro_torch.core.sweep import (
    EndpointStream,
    encode_endpoints,
    probe_count,
    sbm_count,
    sbm_count_exact,
    sequential_sbm_count_numpy,
    sequential_sbm_pairs_numpy,
)
from repro_torch.core.enumerate import (
    enumerate_matches,
    enumerate_matches_sweep_numpy,
    sbm_enumerate,
    sbm_enumerate_planned,
)
from repro_torch.core.runtime import (
    BULK_REGIMES,
    BulkRegimePolicy,
    CapacityPolicy,
    MatchStats,
    StatsRecorder,
    execute_enumeration,
    kernel_builds,
    pairs_via_retry,
    round_up_pow2,
    select_bulk_regime,
)
from repro_torch.core.incremental import BatchDelta, IncrementalIndex
from repro_torch.core.service import DDMService
from repro_torch.core.ddim import (
    bitmatrix_count,
    bitmatrix_enumerate,
    bitmatrix_words,
    enumerate_matches_ddim,
    enumerate_matches_ddim_planned,
    pairs_from_bitmatrix,
    per_dimension_counts,
    select_dimension,
)

__all__ = [
    "CapacityError", "DDMError", "DeadlineExceeded", "GridOverflowError",
    "KernelError", "OverloadError", "ValidationError",
    "Extents", "brute_force_count_numpy", "brute_force_pairs_numpy",
    "intersect_1d", "intersect_ddim", "make_clustered_workload",
    "make_tall_thin_workload", "make_uniform_workload",
    "EndpointStream", "encode_endpoints", "probe_count", "sbm_count",
    "sbm_count_exact", "sequential_sbm_count_numpy",
    "sequential_sbm_pairs_numpy",
    "enumerate_matches", "enumerate_matches_sweep_numpy", "sbm_enumerate",
    "sbm_enumerate_planned",
    "BULK_REGIMES", "BulkRegimePolicy", "CapacityPolicy", "MatchStats",
    "StatsRecorder", "execute_enumeration", "kernel_builds",
    "pairs_via_retry", "round_up_pow2", "select_bulk_regime",
    "BatchDelta", "IncrementalIndex", "DDMService",
    "bitmatrix_count", "bitmatrix_enumerate", "bitmatrix_words",
    "enumerate_matches_ddim", "enumerate_matches_ddim_planned",
    "pairs_from_bitmatrix", "per_dimension_counts", "select_dimension",
]
