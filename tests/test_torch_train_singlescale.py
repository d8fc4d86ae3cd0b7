"""The unrolled training forward of rampvo_tpu_torch in SingleScale mode
against rampvo_tpu's `TrainForward(corr_impl="xla")` on the CPU (the
MultiScale cases and the helpers are in test_torch_train.py)."""

from test_torch_train import check_vs_jax


def test_train_forward_singlescale_vs_jax():
    """SingleScale, one voxel per frame (the reference encoder zips events
    with images): loss, metrics and every parameter's gradient, as
    `check_vs_jax` states."""
    check_vs_jax("SingleScale", False)
