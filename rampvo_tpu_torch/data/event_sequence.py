"""(ts, x, y, p) event sequence container (port of
rampvo_tpu/data/event_sequence.py; ref data/event_sequence.py:11-62).

Numpy feature matrix with timestamp sorting, relative-time conversion,
concatenation and conversion to/from the `Events` struct.
"""

from __future__ import annotations

import numpy as np

from .events import Events

FEATURE_NAMES = ("ts", "x", "y", "p")


class EventSequence:
    def __init__(self, dataframe=None, params=None, features=None,
                 timestamp_multiplier=None, convert_to_relative=False):
        if dataframe is not None:
            # a pandas DataFrame with columns (ts, x, y, p)
            self.feature_names = tuple(dataframe.columns.values)
            self.features = dataframe.to_numpy().astype(np.float64)
        else:
            self.feature_names = FEATURE_NAMES
            self.features = (np.zeros((1, 4)) if features is None
                             else np.asarray(features, np.float64))
        self.image_height = params["height"]
        self.image_width = params["width"]
        if not self.is_sorted():
            self.sort_by_timestamp()
        if timestamp_multiplier is not None:
            self.features[:, 0] *= timestamp_multiplier
        if convert_to_relative:
            self.absolute_time_to_relative()

    def __len__(self):
        return len(self.features)

    def get_sequence_only(self):
        return self.features

    def __add__(self, other: "EventSequence") -> "EventSequence":
        return EventSequence(
            features=np.concatenate([self.features, other.features]),
            params={"height": self.image_height, "width": self.image_width})

    def is_sorted(self) -> bool:
        return bool(np.all(self.features[:-1, 0] <= self.features[1:, 0]))

    def sort_by_timestamp(self):
        if len(self.features) > 0:
            self.features = self.features[np.argsort(self.features[:, 0])]

    def absolute_time_to_relative(self):
        if len(self.features) > 0:
            self.features[:, 0] -= self.features[:, 0].min()

    @classmethod
    def from_events(cls, events: Events) -> "EventSequence":
        feats = np.stack([events.t, events.x, events.y, events.p],
                         axis=1).astype(np.float64)
        return cls(features=feats,
                   params={"height": events.height, "width": events.width})

    def to_events(self) -> Events:
        f = self.features
        return Events(x=f[:, 1].astype(np.uint16), y=f[:, 2].astype(np.uint16),
                      t=f[:, 0].astype(np.int64), p=f[:, 3].astype(np.int8),
                      height=self.image_height, width=self.image_width)
