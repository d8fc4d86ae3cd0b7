"""Pose prediction after the chunked VO path: `cli.evaluate.run_pose_pred`
at chunk=4 (initialized frames in chunks of 4, eagerly on the CPU, one
CUDA-graph replay each on the card) against chunk=1 on the CPU, bit for
bit, through `evaluate_sequence(use_pose_pred=True)`."""

import numpy as np

from rampvo_tpu_torch.cli import evaluate as pev
from rampvo_tpu_torch.vo import VOConfig
from rampvo_tpu_torch.vo import graph as vo_graph
from test_torch_chunk import port_net
from test_torch_pose_pred import EVAL, scene
from test_torch_slice import KW, _torch_threads  # noqa: F401  (fixture)


def test_run_pose_pred_after_chunk(monkeypatch):
    """The 24-frame scene of test_torch_pose_pred at chunk=1 and chunk=4:
    frames 8-11 run as one chunk, n and counter come back from it as host
    values, the 12 predictions and both refinements follow; trajectories,
    ATE and rotation errors equal bit for bit."""
    made, chunks = vo_graph.make_vo_frames_chunk, []

    def counted(*a, **kw):
        run = made(*a, **kw)
        return lambda *b: chunks.append(b[0].n) or run(*b)

    monkeypatch.setattr(vo_graph, "make_vo_frames_chunk", counted)
    data, (_, ref), stamps = scene()
    net = port_net()
    cfg = VOConfig(**dict(KW, KEYFRAME_THRESH=0.0))
    (a1, r1, t1, _, _), (a4, r4, t4, _, _) = (
        pev.evaluate_sequence(cfg, net, EVAL, data, ref, stamps,
                              use_pose_pred=True, device="cpu", seed=2,
                              chunk=k) for k in (1, 4))
    assert chunks == [8]
    assert t4.positions_xyz.shape == (24, 3)
    assert np.isfinite(a4) and a4 != 1000.0
    np.testing.assert_array_equal(t4.positions_xyz, t1.positions_xyz)
    np.testing.assert_array_equal(t4.quat_wxyz, t1.quat_wxyz)
    assert (a4, r4) == (a1, r1)
