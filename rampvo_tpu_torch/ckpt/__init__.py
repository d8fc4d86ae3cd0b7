"""Weights in the reference .pth layout and training checkpoints.
`import_pth` is `load_pth` under the JAX package's name (it returns the
port's state_dict, where the JAX function returns flax variables)."""

from .train_state import restore_checkpoint, save_checkpoint
from .weights import from_flax_params, load_pth, map_state_dict
from .weights import load_pth as import_pth

__all__ = ["import_pth", "map_state_dict", "save_checkpoint",
           "restore_checkpoint", "load_pth", "from_flax_params"]
