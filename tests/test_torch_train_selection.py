"""The unrolled training forward without event bias (patches at random
or ranked by image gradient, `TrainForward(event_bias=False,
gradient_bias=...)`) against rampvo_tpu's `corr_impl="xla"` forward, with
the JAX run's draws, selection integers included (see
tests/test_torch_train.py::check_vs_jax for the size and tolerances)."""

import pytest

from test_torch_train import _torch_threads, check_vs_jax  # noqa: F401


@pytest.mark.parametrize("selection", ["random", "gradient"])
def test_train_forward_selection_vs_jax(selection):
    """MultiScale, poses free (no structure-only warmup)."""
    check_vs_jax("MultiScale", False, selection)
