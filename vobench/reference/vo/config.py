"""VO runtime configuration (port of rampvo_tpu/vo/config.py).

The port always runs the lattice path, and the tensor's device picks
kernel or plain version, so the reference's CORR_IMPL, PALLAS_ENCODER,
CELL_REPROJECT and CELL_LINEARIZE are left out. CORR_LAYOUT is kept: it
picks the update's correlation kernel and the layout it hands to the
update operator (see CORR_LAYOUTS). `from_yaml` consumes the reference's
config_vo files unchanged; an unknown CORR_LAYOUT raises.
"""

from __future__ import annotations

import dataclasses

# CORR_LAYOUT -> the column layout its kernel hands the update operator
# (vo/runtime.py::_lattice_corr): fused3 K1 and fused4 K6 emit corr_fc1's
# own [E, 882] order; fused2 K5 the paired and folded K4 (its folded
# kernel on the card) the folded layout, read through
# models.vonet.fold_corr_fc1.
CORR_LAYOUTS = {"fused3": "reference", "fused4": "reference",
                "fused2": "paired", "folded": "folded"}


@dataclasses.dataclass(frozen=True)
class VOConfig:
    # ref defaults: ramp/config.py:3-27
    BUFFER_SIZE: int = 2048
    PATCHES_PER_FRAME: int = 96
    REMOVAL_WINDOW: int = 22
    OPTIMIZATION_WINDOW: int = 10
    PATCH_LIFETIME: int = 13
    KEYFRAME_INDEX: int = 4
    KEYFRAME_THRESH: float = 15.0
    MOTION_MODEL: str = "DAMPED_LINEAR"
    MOTION_DAMPING: float = 0.5
    MIXED_PRECISION: bool = True   # bf16 parameters and activations
    GRADIENT_BIAS: bool = False

    # motion-probe gate threshold (ref: Ramp_vo.py:385); < 0 disables it
    PROBE_THRESH: float = 2.0
    BA_ITERS: int = 2            # GN iterations per update (Ramp_vo.py:304)

    MAX_FRAMES: int = 4096       # global frame-id capacity (>= total frames)
    MEM: int = 40                # feature ring depth (slots)

    # the update's lattice correlation (ref vo/config.py:73); one of
    # CORR_LAYOUTS. The reference sends any other string to its folded
    # kernel but folds corr_fc1 for the paired layout; the port raises.
    CORR_LAYOUT: str = "fused3"

    def __post_init__(self):
        if self.CORR_LAYOUT not in CORR_LAYOUTS:
            raise ValueError(f"CORR_LAYOUT {self.CORR_LAYOUT!r} is not one of "
                             f"{sorted(CORR_LAYOUTS)}")

    @property
    def corr_fc1_layout(self) -> str:
        """Column layout of the correlation the update operator reads."""
        return CORR_LAYOUTS[self.CORR_LAYOUT]

    @property
    def M(self) -> int:
        return self.PATCHES_PER_FRAME

    @property
    def NI(self) -> int:
        # edge-lattice host rows: hosts within REMOVAL_WINDOW, +3 slack so a
        # reused row's previous occupant is always aged out
        return self.REMOVAL_WINDOW + 3

    @property
    def T(self) -> int:
        # edge-lattice target offsets (Ramp_vo.py:312-325)
        return 2 * self.PATCH_LIFETIME - 1

    @property
    def EDGE_CAPACITY(self) -> int:
        return self.NI * self.T * self.M

    @property
    def POSE_WINDOW(self) -> int:
        return self.REMOVAL_WINDOW + 4

    @property
    def FEATURE_WINDOW(self) -> int:
        return min(self.REMOVAL_WINDOW + self.PATCH_LIFETIME, self.MEM - 2)

    @property
    def PATCH_WINDOW(self) -> int:
        return self.POSE_WINDOW * self.M

    @classmethod
    def from_yaml(cls, path: str) -> "VOConfig":
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in fields})
