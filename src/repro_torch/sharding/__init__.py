from .rules import (NamedSharding, PartitionSpec, rules_for_profile,
                    shard_batch_spec, spec_for, tree_shardings)

__all__ = ["NamedSharding", "PartitionSpec", "rules_for_profile",
           "shard_batch_spec", "spec_for", "tree_shardings"]
