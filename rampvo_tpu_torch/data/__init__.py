"""Host data path: events, the HDF5 event stream, event representations
and the per-scene loader (port of rampvo_tpu/data). File readers (h5py,
hdf5plugin, PIL, cv2) are imported inside the functions that read files."""

from .event_handle import H5EventHandle
from .event_sequence import EventSequence
from .events import Events
from .loader import data_loader_all_events, normalize_image, resize_input
from .representations import EventToStack, EventsToVoxelGrid

__all__ = [
    "Events",
    "EventSequence",
    "H5EventHandle",
    "EventToStack",
    "EventsToVoxelGrid",
    "data_loader_all_events",
    "normalize_image",
    "resize_input",
]
