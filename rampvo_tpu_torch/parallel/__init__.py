"""Scale-out over processes: the scene-sharded evaluation fleet."""

from .eval_fleet import parse_shard, run_fleet, shard_scenes

__all__ = ["run_fleet", "parse_shard", "shard_scenes"]
