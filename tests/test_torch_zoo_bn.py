"""The port's model lattice with batch norm (``is_bn``) against the JAX
package's, as ``tests/test_torch_zoo.py`` holds it without: the eval
forward on moving statistics that one train-mode batch moved, the
train-mode loss and gradients, and the moving statistics after that batch.
With batch norm the MMoE experts take the reference's per-expert path.
The params come from the port's init, handed to JAX as numpy (``case``)."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_zoo import (MODELS, assert_trees_close, case,  # noqa: E402
                            check_eval_forward, check_loss_and_grads,
                            leaves)


@pytest.mark.parametrize("model_type", MODELS)
def test_eval_forward_matches_jax(model_type):
    check_eval_forward(model_type, True)


@pytest.mark.parametrize("model_type", MODELS)
def test_train_loss_and_grads_match_jax(model_type):
    check_loss_and_grads(model_type, True)


@pytest.mark.parametrize("model_type", MODELS)
def test_bn_moving_stats_match_jax(model_type):
    """After one train-mode batch: decay 0.9 from zero, so each moving
    statistic is 0.1 of the batch's.  ``lr`` has no batch norm to keep
    statistics of (one dense layer), on either side."""
    c = case(model_type, True)
    if model_type == "lr":
        assert c["pstate"] == {} and not dict(leaves(c["jstate"]))
        return
    assert dict(leaves(c["jstate"]))
    assert_trees_close(c["pstate"], c["jstate"], "model state")
