"""repro_torch.core — Parallel Sort-Based Matching (Marzolla & D'Angelo,
DS-RT'17) in PyTorch, plus the baselines the paper compares against.

Public surface (the JAX package's ``repro.core``; ``kernel_builds``
stands where it has ``jit_compiles``; the ``*_sharded`` engines take a
``torch.distributed`` ``DeviceMesh`` and one of its dimension names):
  Extents, make_uniform_workload           — containers & paper workloads
  sbm_count (scan_impl=...), sbm_count_sharded — the paper's parallel SBM
  sequential_sbm_count_numpy               — Algorithm 4 (serial baseline)
  rank_count, per_sub_match_counts         — ITM's searchsorted analogue
  bf_count, bf_count_sharded               — brute force (Algorithm 2)
  grid_count                               — grid-based matching (§3.2)
  sbm_enumerate, sbm_enumerate_sharded     — sweep pair enumeration (O(K))
  enumerate_matches_ddim, select_dimension — d-dim selective-dimension sweep
  bitmatrix_count/enumerate/sharded        — d-dim packed bit-matrix AND
  enumerate_matches, match_matrix, ...     — oracle/structure reporting
  IncrementalIndex, BatchDelta             — persistent index + delta rematch
  DDMService                               — HLA-style service facade
  execute_enumeration, pairs_via_retry     — planned/instrumented executor
  CapacityPolicy, BulkRegimePolicy, ...    — the runtime planner
"""
from repro_torch.core.intervals import (
    Extents,
    intersect_1d,
    intersect_ddim,
    make_uniform_workload,
    make_clustered_workload,
    make_tall_thin_workload,
    brute_force_count_numpy,
    brute_force_pairs_numpy,
)
from repro_torch.core.sweep import (
    EndpointStream,
    encode_endpoints,
    probe_count,
    sbm_count,
    sbm_count_exact,
    sbm_count_sharded,
    sbm_active_profile,
    active_sets_at_segment_starts,
    sequential_sbm_count_numpy,
    sequential_sbm_pairs_numpy,
    sequential_sbm_pairs_numpy_ddim,
)
from repro_torch.core.rank import (
    rank_count,
    rank_count_sharded,
    per_sub_match_counts,
    per_upd_match_counts,
)
from repro_torch.core.brute_force import bf_count, bf_count_sharded
from repro_torch.core.errors import (
    DDMError,
    ValidationError,
    OverloadError,
    DeadlineExceeded,
    KernelError,
)
from repro_torch.core.grid import GridOverflowError, grid_count
from repro_torch.core.enumerate import (
    enumerate_matches,
    enumerate_matches_sweep_numpy,
    sbm_enumerate,
    sbm_enumerate_planned,
    sbm_enumerate_sharded,
)
from repro_torch.core.ddim import (
    bitmatrix_count,
    bitmatrix_enumerate,
    bitmatrix_sharded,
    bitmatrix_words,
    enumerate_matches_ddim,
    enumerate_matches_ddim_planned,
    pairs_from_bitmatrix,
    per_dimension_counts,
    select_dimension,
)
from repro_torch.core.runtime import (
    BULK_REGIMES,
    BulkRegimePolicy,
    CapacityError,
    CapacityPolicy,
    MatchStats,
    StatsRecorder,
    execute_enumeration,
    kernel_builds,
    pairs_via_retry,
    round_up_pow2,
    select_bulk_regime,
)
from repro_torch.core.matrix import (
    match_matrix,
    match_matrix_ddim,
    row_index_lists,
    block_extents_for_sequence,
    block_mask_from_extents,
    document_extents,
)
from repro_torch.core.incremental import BatchDelta, IncrementalIndex
from repro_torch.core.service import DDMService

# the JAX package's list in its order, with kernel_builds for
# jit_compiles.  probe_count, pairs_from_bitmatrix and KernelError import
# from here too.
__all__ = [
    "Extents", "intersect_1d", "intersect_ddim", "make_uniform_workload",
    "make_clustered_workload", "make_tall_thin_workload",
    "brute_force_count_numpy", "brute_force_pairs_numpy",
    "EndpointStream", "encode_endpoints", "sbm_count", "sbm_count_exact",
    "sbm_count_sharded",
    "sbm_active_profile", "active_sets_at_segment_starts",
    "sequential_sbm_count_numpy", "sequential_sbm_pairs_numpy",
    "sequential_sbm_pairs_numpy_ddim",
    "rank_count", "rank_count_sharded", "per_sub_match_counts",
    "per_upd_match_counts", "bf_count", "bf_count_sharded", "grid_count",
    "DDMError", "ValidationError", "OverloadError", "DeadlineExceeded",
    "GridOverflowError",
    "enumerate_matches", "enumerate_matches_ddim",
    "enumerate_matches_ddim_planned", "enumerate_matches_sweep_numpy",
    "sbm_enumerate", "sbm_enumerate_planned", "sbm_enumerate_sharded",
    "BULK_REGIMES", "BulkRegimePolicy", "CapacityError", "CapacityPolicy",
    "MatchStats", "StatsRecorder", "execute_enumeration", "kernel_builds",
    "pairs_via_retry", "round_up_pow2", "select_bulk_regime",
    "bitmatrix_count", "bitmatrix_enumerate", "bitmatrix_sharded",
    "bitmatrix_words", "per_dimension_counts", "select_dimension",
    "match_matrix", "match_matrix_ddim", "row_index_lists",
    "block_extents_for_sequence", "block_mask_from_extents", "document_extents",
    "BatchDelta", "IncrementalIndex", "DDMService",
]
