"""Model-side parallelism on ``torch.distributed``: the logical-axis
Sharder and its rule table, the tensor-parallel collectives, context
parallelism and the int8 compressed reduction."""
from repro_torch.parallel.sharding import (DEFAULT_RULES, MeshShape,
                                           PartitionSpec, Sharder,
                                           gather_params, make_sharder,
                                           rules_for_config, shard_params,
                                           tree_named_shardings)

__all__ = ["DEFAULT_RULES", "MeshShape", "PartitionSpec", "Sharder",
           "gather_params", "make_sharder", "rules_for_config",
           "shard_params", "tree_named_shardings"]
