"""The benchmark's torch scene agrees with the port's numpy scene
(rampvo_tpu_torch/data/synthetic.py) and its stack representation."""

import numpy as np
import pytest
import torch

from rampvo_tpu_torch.data import synthetic
from rampvo_tpu_torch.data.events import Events
from rampvo_tpu_torch.data.representations import stack_numpy
from vobench import scene

H, W, N = 30, 40, 6


def numpy_texture(seed):
    """render_sequence's texture, before its smoothing."""
    return np.random.RandomState(seed).rand(3 * H, 3 * W) * 255.0


@pytest.mark.parametrize("motion", ["curve", "line"])
def test_frames_agree(motion):
    fx = 60.0
    images, poses, intr = synthetic.render_sequence(N, H, W, fx=fx, seed=3,
                                                    motion=motion)
    tex = scene.smooth(torch.from_numpy(numpy_texture(3)))
    for i in range(N):
        mine = scene.render(tex, H, W, fx, synthetic.PLANE_Z, i, motion)
        np.testing.assert_allclose(mine.numpy(), images[i], rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(scene.camera_xy(i, motion), poses[i, :2])
    np.testing.assert_allclose(intr, [fx, fx, W / 2, H / 2])


def test_voxels_agree_with_the_stack_of_the_same_events():
    images, _, _ = synthetic.render_sequence(N, H, W, seed=5, motion="curve")
    x, y, t, p = synthetic.events_from_images(images)
    for i in range(1, N):
        sel = (t >= (i - 1) * 1000) & (t < i * 1000)
        ev = Events(x=x[sel], y=y[sel], t=t[sel], p=p[sel], height=H,
                    width=W)
        want = np.transpose(stack_numpy(ev, 5), (1, 2, 0))
        got = scene.stack_voxel(torch.from_numpy(images[i] - images[i - 1]),
                                6.0, 5)
        np.testing.assert_array_equal(got.numpy(), want)


def test_pool_plays_forward_and_back():
    p = {"pool_frames": 5, "fx": 60.0, "plane_z": 2.0, "motion": "curve",
         "event_thresh": 6.0, "bins": 5}
    ev, im, intr = scene.make_pool(p, H, W, 11, "cpu")
    assert ev.shape == (8, 1, H, W, 5) and ev.dtype == torch.int8
    assert im.shape == (8, 1, H, W, 3) and im.dtype == torch.float16
    # the backward step from frame 4 to 3 retraces the step from 3 to 4
    assert torch.equal(ev[4], -ev[3])
    assert torch.equal(im[4], im[2])
    # images as the loader normalizes 8-bit frames
    assert float(im.min()) >= -0.5 and float(im.max()) <= 1.5
