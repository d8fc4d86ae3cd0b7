"""Scale-out over processes: data-parallel training over ranks (`mesh`)
and the scene-sharded evaluation fleet."""

from .eval_fleet import parse_shard, run_fleet, shard_scenes
from .mesh import eval_shard_scenes, make_mesh, make_train_step, shard_batch

__all__ = [
    "make_mesh", "shard_batch", "make_train_step", "eval_shard_scenes",
    "run_fleet", "parse_shard", "shard_scenes",
]
