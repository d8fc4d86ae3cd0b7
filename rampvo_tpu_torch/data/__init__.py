"""Host data path: events, the HDF5 event stream, event representations,
the per-scene loader (port of rampvo_tpu/data) and the synthetic scene
(data/synthetic.py, on files or in memory). File readers (h5py,
hdf5plugin, PIL, cv2) are imported inside the functions that read files."""

from .event_handle import H5EventHandle
from .event_sequence import EventSequence
from .events import Events
from .loader import data_loader_all_events, normalize_image, resize_input
from .representations import EventToStack, EventsToVoxelGrid
from .synthetic import (MemoryDataset, MemoryEvents, events_from_images,
                        memory_eval_data, memory_reader, memory_scene,
                        render_sequence, write_scene)

__all__ = [
    "Events",
    "EventSequence",
    "H5EventHandle",
    "EventToStack",
    "EventsToVoxelGrid",
    "data_loader_all_events",
    "normalize_image",
    "resize_input",
    "render_sequence",
    "events_from_images",
    "write_scene",
    "MemoryEvents",
    "memory_scene",
    "MemoryDataset",
    "memory_eval_data",
    "memory_reader",
]
