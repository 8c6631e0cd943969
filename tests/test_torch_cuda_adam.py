"""The multi-tensor dense Adam kernel (``csrc/adam_dense.cu``) against the
plain step leaf by leaf (``ops/adam.py`` ``adam_dense_ref``) on the card.

These tests need a CUDA card and skip without one; run them on the H100
with ``python -m pytest -m cuda tests/test_torch_cuda_adam.py``.  They
import only PyTorch and the port, so they run where JAX is not
installed."""

import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from cikm2020_dmt_torch.core import tracing  # noqa: E402
from cikm2020_dmt_torch.ops import adam  # noqa: E402
from cikm2020_dmt_torch.train.optim import (  # noqa: E402
    adam_scalars, piecewise_constant)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m cuda "
                    "tests/test_torch_cuda_adam.py` on the H100")
    return torch.device("cuda")


def _scalars(step: int, dev):
    """Step ``step``'s lr, bc1 and bc2 as ``optim.adam_update`` forms
    them."""
    count = torch.tensor(step - 1, dtype=torch.int64, device=dev)
    return adam_scalars(count, piecewise_constant((2,), (1e-3, 1e-4)))[1:]


def _dmt_shapes():
    """(shape, dtype) of every dense leaf of ``conf/dmt.conf``'s trainer,
    in order."""
    from cikm2020_dmt_torch.core.config import DMTConfig
    from cikm2020_dmt_torch.train.loop import Trainer, _flatten

    conf = Path(__file__).resolve().parent.parent / "conf" / "dmt.conf"
    tr = Trainer(DMTConfig.from_ini(str(conf)), device="cpu")
    dense = tr._dense(tr.model.init(torch.Generator().manual_seed(0)))
    return [(tuple(t.shape), t.dtype) for t in _flatten(dense, [])]


def _tree(dev, gen):
    """(p, g) of every awkward leaf and of the flagship's dense leaves:
    0-dim, one element, sizes off the vector width, misaligned views,
    gradients cut from a wider matrix (vector-aligned rows and not),
    float32 and bfloat16, a bfloat16 p with a float32 g."""
    def r(*shape, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev)
                * 0.5).to(dtype)
    out = []
    for dt in (torch.float32, torch.bfloat16):
        out += [(r(dtype=dt), r(dtype=dt)), (r(1, dtype=dt), r(1, dtype=dt)),
                (r(7, dtype=dt), r(7, dtype=dt)),
                (r(3, 5, dtype=dt), r(3, 5, dtype=dt)),
                (r(3 * adam.TILE + 13, dtype=dt),
                 r(3 * adam.TILE + 13, dtype=dt)),
                (r(0, 4, dtype=dt), r(0, 4, dtype=dt))]
        big = r(1000, dtype=dt)
        out.append((big[1:1 + 411].view(3, 137), r(3, 137, dtype=dt)))
        out.append((r(80, 80, dtype=dt), r(80, 240, dtype=dt)[:, 80:160]))
        out.append((r(37, 3, dtype=dt), r(37, 6, dtype=dt)[:, 3:]))
        out.append((r(9, 4, dtype=dt), r(4, 9, dtype=dt).t()))
    out.append((r(5, 8, dtype=torch.bfloat16), r(5, 8)))
    for k, (shape, dt) in enumerate(_dmt_shapes()):
        p = r(*shape, dtype=dt)
        if len(shape) == 2 and k % 2:
            g = r(shape[0], 3 * shape[1], dtype=dt)[:, shape[1]:2 * shape[1]]
        else:
            g = r(*shape, dtype=dt)
        out.append((p, g))
    return out


@pytest.mark.cuda
def test_fused_step_same_bits_as_plain_step_on_card(cuda_device):
    """Three steps with the same lr / bc1 / bc2 tensors on both sides: p',
    m' and v' bit-equal to the plain per-leaf step's on every leaf (float32
    and bfloat16, the flagship's 138 dense leaves among them, more than two
    launches' worth); the inputs unchanged; the counters as planned."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(0)
    pairs = _tree(dev, gen)
    n_real = sum(1 for p, _ in pairs if p.numel())
    launches = -(-n_real // adam.MAX_LEAVES)
    assert launches >= 3
    fused = [(p, torch.zeros(p.shape, device=dev),
              torch.zeros(p.shape, device=dev)) for p, _ in pairs]
    plain = list(fused)
    for step in range(1, 4):
        lr, bc1, bc2 = _scalars(step, dev)
        f_in = [(p, g, m, v) for (p, m, v), (_, g) in zip(fused, pairs)]
        p_in = [(p, g, m, v) for (p, m, v), (_, g) in zip(plain, pairs)]
        before = [[t.clone() for t in leaf] for leaf in f_in]
        n0 = adam.adam_dense.launches
        with tracing.recording():
            got = adam.adam_dense(f_in, lr, bc1, bc2)
        counters = tracing.snapshot()["counters"]
        want = adam.adam_dense_ref(p_in, lr, bc1, bc2)
        torch.cuda.synchronize()
        assert adam.adam_dense.launches - n0 == launches
        assert counters == {"optim.fused_leaves": len(pairs),
                            "optim.fused_launches": launches}
        for k, (g3, w3) in enumerate(zip(got, want)):
            for what, x, y in zip("pmv", g3, w3):
                assert x.dtype == y.dtype and x.shape == y.shape, (k, what)
                assert torch.equal(x, y), (step, k, what, tuple(x.shape),
                                           x.dtype)
        for k, (leaf, b) in enumerate(zip(f_in, before)):
            assert all(torch.equal(x, y) for x, y in zip(leaf, b)), k
        fused, plain = got, want


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["float16", "float64", "bf16_moments",
                                  "scalars_on_cpu"])
def test_a_leaf_that_does_not_fit_raises_on_card(cuda_device, what):
    """A card leaf of another type, or a step's scalars off the card,
    raises before any launch, naming the tensor; no leaf falls back to the
    plain version on the card."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(1)
    dt = {"float16": torch.float16, "float64": torch.float64}.get(
        what, torch.float32)
    p = torch.randn(33, 5, generator=gen, device=dev).to(dt)
    g = torch.randn(33, 5, generator=gen, device=dev).to(dt)
    z = torch.zeros(33, 5, device=dev,
                    dtype=torch.bfloat16 if what == "bf16_moments"
                    else torch.float32)
    ok = torch.zeros(33, 5, device=dev)
    lr, bc1, bc2 = _scalars(1, "cpu" if what == "scalars_on_cpu" else dev)
    named = {"float16": "p torch.float16", "float64": "p torch.float64",
             "bf16_moments": "m torch.bfloat16",
             "scalars_on_cpu": "lr torch.float32 () on cpu"}[what]
    n0 = adam.adam_dense.launches
    with pytest.raises(ValueError, match=re.escape(named)):
        adam.adam_dense([(ok, ok, ok, ok), (p, g, z, z)], lr, bc1, bc2)
    assert adam.adam_dense.launches == n0
