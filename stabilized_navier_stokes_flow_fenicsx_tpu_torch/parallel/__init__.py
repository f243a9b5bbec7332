"""The multi-device layer on ``torch.distributed``: one process per rank."""

from .shard import ShardedProblem, make_sharded_problem, sharded_newton
