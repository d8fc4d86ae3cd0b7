"""VO runtime configuration (port of rampvo_tpu/vo/config.py).

The reference's TPU-only knobs (CORR_IMPL, CORR_LAYOUT, PALLAS_ENCODER,
CELL_REPROJECT, CELL_LINEARIZE) are left out: the port always runs the
lattice path, and the tensor's device picks kernel or plain version.
`from_yaml` consumes the reference's config_vo files unchanged.
"""

from __future__ import annotations

import dataclasses


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
