"""Host data path of the evaluation CLI: events, the HDF5 event stream,
event representations and the per-scene loader (port of the inference
part of rampvo_tpu/data/). File readers (h5py, hdf5plugin, PIL, cv2) are
imported inside the functions that read files."""
