"""Two ``gloo`` ranks of the port's data mesh against the JAX ``Trainer``
on a (2, 1) mesh (``tests/test_torch_mesh.py``'s setup), one step each:

- batch norm (``embed_mlp`` with ``is_bn``): the normalising statistics
  and the moving ones are the global batch's on both sides, so the loss,
  the state and the moving statistics match;
- ``fms_grad_bf16``: the gradient rows go to their owners in bfloat16 and
  are summed in float32 there, as in JAX;
- ``wnd`` with ``wnd_wd`` 1e-3 (no lazy table): the embedding L2 counts
  each row the global batch touches once, whichever ranks touch it."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import __graft_entry__ as g  # noqa: E402
from test_torch_mesh import (B, check_state, mesh_config,  # noqa: E402
                             port_cfg, run_jax, run_port)
from test_torch_train import leaves, port_view  # noqa: E402


def one_step(cfg, seed=4):
    batches = [g.synthetic_batch(cfg, B, seed=seed)]
    jax_run = run_jax(cfg, 2, batches)
    return jax_run, run_port(cfg, 2, jax_run["states"][0], batches)


def test_batch_norm_takes_the_global_batch():
    cfg = mesh_config(model_type="embed_mlp", is_bn=True)
    jax_run, ranks = one_step(cfg)
    want = port_view(port_cfg(cfg), jax_run["states"][1])
    got = ranks[0]["states"][0]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], jax_run["losses"],
                                   rtol=1e-5)
    # the dense biases in front of batch norm have a zero gradient: their
    # m is rounding noise on both sides
    check_state(port_cfg(cfg), got, want, m_noise=1e-6)
    stats = list(zip(leaves(got["model_state"]),
                     leaves(want["model_state"])))
    assert stats
    for (path, a), (_, b) in stats:
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-6 * np.abs(b).max(), err_msg=path)


def test_fms_grad_bf16_matches_jax():
    cfg = mesh_config(fms_grad_bf16=True)
    jax_run, ranks = one_step(cfg)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], jax_run["losses"],
                                   rtol=1e-5)
    check_state(port_cfg(cfg), ranks[0]["states"][0],
                port_view(port_cfg(cfg), jax_run["states"][1]))


def test_wnd_embedding_l2_counts_the_global_batch():
    # l2_emb_lambda 1 (default 0.01): the embedding term then stands out
    # of the dense weight decay's in the loss, at about 0.3 of its 164
    cfg = mesh_config(model_type="wnd", wnd_wd=1e-3, l2_emb_lambda=1.0)
    jax_run, ranks = one_step(cfg)
    assert ranks[0]["plan"] == []
    for r in ranks:
        np.testing.assert_allclose(r["losses"], jax_run["losses"],
                                   rtol=1e-5)
    check_state(port_cfg(cfg), ranks[0]["states"][0],
                port_view(port_cfg(cfg), jax_run["states"][1]), lazy=())
