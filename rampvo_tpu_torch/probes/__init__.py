"""Measurement probes. With hand-written kernels (csrc/probes.cu): P1
`dynlane` (a table-driven dynamic-bound loop with dynamic row offsets) and
P2 `grid_probe` (the cost of a launch and of a block); they compute
nothing of the system, and `chip_smoke.py` runs them on the card. The VO
frame split by stage: `frame` (the frame with stages removed) and
`breakdown` (`cli.bench --breakdown`)."""
