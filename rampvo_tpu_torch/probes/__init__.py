"""Measurement probes with hand-written kernels (csrc/probes.cu): P1
`dynlane` (a table-driven dynamic-bound loop with dynamic row offsets) and
P2 `grid_probe` (the cost of a launch and of a block). They compute nothing
of the system; `chip_smoke.py` runs them on the card."""
