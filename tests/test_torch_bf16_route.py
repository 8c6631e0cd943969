"""Two routes of the bfloat16 path against the JAX package:

- bfloat16 tables past ``onehot_bwd_rows_max``.  With
  ``onehot_bwd_rows_max`` 1,024 and unpacked tables, the JAX package looks
  the 2,048-row Cid3, Brand and Shopid (bfloat16, dense Adam: lazy Adam
  starts at ``dedup_rows_threshold`` 4,096, Sku) up with a plain
  ``jnp.take``, whose backward adds the cotangents into the table's type:
  on the CPU a bfloat16 scatter-add that rounds after every add.  The port
  sums them in float32 and rounds once, as on the one-hot route
  (``conf/dmt.conf``'s Brand and Shopid take this route).  Two ``Trainer``
  steps under the bfloat16 rule of ``test_torch_bf16_train.py``; the three
  tables' gradients are among the leaves it holds.
- the eval forward of this config (bfloat16 compute, the tables of at
  least 500 rows bfloat16, as the benchmark's) on the state after the two
  JAX steps: logits within twice
  the JAX bfloat16 forward's distance from the port's float32 forward,
  plus 1e-4 of their largest |value|."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as g  # noqa: E402
from cikm2020_dmt_tpu.models.zoo import build_model as j_build  # noqa: E402
from cikm2020_dmt_torch.convert import params_from_jax  # noqa: E402
from cikm2020_dmt_torch.models.zoo import build_model  # noqa: E402
from chip_smoke import (BF16_EVAL_TOL, BWD_BF16_FACTOR,  # noqa: E402
                        BWD_TOL_F32, float32_reference)
from test_torch_bf16_train import (CHECKS, _grads, _np,  # noqa: E402
                                   bf16_config, bf16_run, fused_block, widen)
from test_torch_train import B, port_view  # noqa: E402

ROUTE = dict(table_bf16_threshold=500, onehot_bwd_rows_max=1024,
             pack_rows_threshold=10**9, dedup_rows_threshold=4096)
ROUTE_TABLES = ("Cid3", "Brand", "Shopid")


@pytest.fixture(scope="module")
def run():
    return bf16_run(bf16_config(**ROUTE))


@pytest.mark.parametrize("check", sorted(CHECKS))
@pytest.mark.parametrize("step", [1, 2])
def test_route_step_matches_jax(run, step, check):
    CHECKS[check](run, step)


def route_distances(run, step):
    """Per table of the route: (port vs JAX, JAX vs float32, port vs
    float32), norm-wise, of the step's gradient."""
    want = _grads(run, port_view(run["pcfg"], run["jstates"][step]), step)
    got = _grads(run, _np(run["steps"][step - 1]["port"][0]), step)
    ref = _grads(run, _np(run["steps"][step - 1]["f32"][0]), step)
    out = {}
    for t in ROUTE_TABLES:
        w, p, r = (d["/emb/" + t] for d in (want, got, ref))
        n = np.linalg.norm
        out[t] = (n(p - w) / n(w), n(w - r) / n(r), n(p - r) / n(r))
    return out


@pytest.mark.parametrize("step", [1, 2])
def test_route_tables_are_on_the_plain_route(run, step):
    """Cid3, Brand and Shopid: bfloat16, dense (not lazy), past the
    one-hot rows; the printed distances are ROADMAP's record."""
    emb = run["steps"][step - 1]["port"][0]["params"]["emb"]
    for t in ROUTE_TABLES:
        assert emb[t].dtype == torch.bfloat16
        assert emb[t].shape[0] > run["cfg"].onehot_bwd_rows_max
    assert run["lazy"] == 1      # Sku
    for t, (pj, jf, pf) in route_distances(run, step).items():
        print(f"step {step} {t}: port vs JAX {pj:.3e}, JAX vs float32 "
              f"{jf:.3e}, port vs float32 {pf:.3e}")
        assert pj <= BWD_BF16_FACTOR * jf + BWD_TOL_F32


def test_eval_forward_matches_jax(run):
    cfg, pcfg = run["cfg"], run["pcfg"]
    params = run["jstates"][2]["params"]
    batch = g.synthetic_batch(cfg, B, seed=7)
    jm = j_build(cfg)
    with fused_block():
        want = jax.jit(lambda p, b: jm.apply(p, {}, b, train=False,
                                             is_predict=False)[0])(
            jax.tree_util.tree_map(jnp.asarray, params),
            {k: jnp.asarray(v) for k, v in batch.items()})
    want = [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(want)]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tp = params_from_jax(pcfg, params)
    got = build_model(pcfg).apply(tp, tb, train=False, is_predict=False)
    ref = build_model(float32_reference(pcfg)).apply(
        widen(tp), tb, train=False, is_predict=False)
    got = [x.double().numpy() for x in jax.tree_util.tree_leaves(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor))]
    ref = [x.double().numpy() for x in jax.tree_util.tree_leaves(
        ref, is_leaf=lambda x: isinstance(x, torch.Tensor))]
    assert len(got) == len(want) == len(ref) == 3   # click, order, bias
    for a, w, r in zip(got, want, ref):
        assert a.shape == w.shape
        tol = BWD_BF16_FACTOR * np.abs(w - r).max() + BF16_EVAL_TOL * np.abs(
            w).max()
        assert np.abs(a - w).max() <= tol, (np.abs(a - w).max(), tol)
