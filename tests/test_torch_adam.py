"""The host side of the multi-tensor dense Adam (``ops/adam.py``), on the
CPU: the records' layout against ``csrc/adam_dense.cu``, the launches'
plan (at most ``MAX_LEAVES`` leaves, tiles numbered from 0 in each), the
kind bits, which leaves take the kernel and which raise, the plain path
and its counters; and the packed launches run by a NumPy model
of the kernel (its tile search, offsets and loads, over the pointers the
wrapper packed), held bit for bit against the plain version."""

import contextlib
import ctypes
import functools
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cikm2020_dmt_torch.core import tracing  # noqa: E402
from cikm2020_dmt_torch.ops import _build, adam  # noqa: E402
from cikm2020_dmt_torch.train import lazy, optim  # noqa: E402

SOURCE = Path(adam.__file__).resolve().parent.parent / "csrc" / \
    "adam_dense.cu"


@pytest.fixture(autouse=True)
def clean_tracer():
    tracing.snapshot()
    yield
    tracing.snapshot()


def _constexpr(name: str) -> int:
    m = re.search(rf"constexpr int {name} = ([^;]+);", SOURCE.read_text())
    return m.group(1)


def test_records_match_the_kernel_source():
    """Leaf 64 bytes, header 64, a launch's block 4096 (the classic kernel
    parameter limit); field offsets as the C structs lay them out; tile,
    slot count and kind bits as the source defines them."""
    assert adam.LEAF.itemsize == 64 and adam.HEAD.itemsize == 64
    assert adam.CHUNK.itemsize == 4096
    offsets = {k: v[1] for k, v in adam.LEAF.fields.items()}
    assert offsets == {"p": 0, "g": 8, "m": 16, "v": 24, "p_out": 32,
                       "out": 40, "n": 48, "tile0": 56, "kind": 60}
    head = {k: v[1] for k, v in adam.HEAD.fields.items()}
    assert head == {"lr": 0, "bc1": 8, "bc2": 16, "m_out": 24, "v_out": 32,
                    "c": 40, "pad": 60}
    assert adam.CHUNK.fields["leaf"][1] == 64
    assert _constexpr("kThreads") == "256" and _constexpr("kGroups") == "2"
    assert adam.TILE == 256 * 2 * 4
    assert int(_constexpr("kMaxLeaves")) == adam.MAX_LEAVES
    for name, bit in (("kPBf16", adam.P_BF16), ("kGBf16", adam.G_BF16),
                      ("kVector", adam.VECTOR)):
        assert int(_constexpr(name)) == bit, name


def test_constants_are_torch_float32_scalars():
    """The header's constants are what torch multiplies a float32 tensor
    by for the Python scalars of ``adam_leaf_ref``."""
    one = torch.ones(1)
    want = [float((1.0 - adam.B1) * one), float(adam.B1 * one),
            float((1.0 - adam.B2) * one), float(adam.B2 * one),
            float(one * 0 + adam.EPS)]
    np.testing.assert_array_equal(adam.constants(),
                                  np.array(want, dtype=np.float32))
    assert optim.B1 is adam.B1 and lazy.EPS is adam.EPS


@pytest.mark.parametrize("n_leaves", [1, 62, 63, 64, 126, 127, 138, 222])
def test_plan_cuts_launches_at_the_parameter_block(n_leaves):
    rng = np.random.default_rng(n_leaves)
    sizes = [int(x) for x in rng.integers(0, 3 * adam.TILE, n_leaves)]
    sizes[0] = 0                     # left out
    if n_leaves > 1:
        sizes[-1] = 5 * adam.TILE + 1
    plan = adam.plan(sizes)
    real = [i for i, n in enumerate(sizes) if n]
    assert len(plan) == -(-len(real) // adam.MAX_LEAVES)
    assert [i for idx, _, _ in plan for i in idx] == real
    for idx, tile0, tiles in plan:
        assert 1 <= len(idx) <= adam.MAX_LEAVES
        want, t = [], 0
        for i in idx:
            want.append(t)
            t += -(-sizes[i] // adam.TILE)
        assert tile0 == want and tiles == t
    assert all(len(idx) == adam.MAX_LEAVES for idx, _, _ in plan[:-1])


def test_plan_of_no_element():
    assert adam.plan([]) == [] and adam.plan([0, 0]) == []


@pytest.mark.parametrize("dtypes", [
    (torch.float32, torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.float32, torch.float32),
    (torch.float32, torch.bfloat16, torch.float32),
])
def test_takes_kernel_on_the_card(dtypes):
    """float32 and bfloat16 parameters and gradients with float32 moments
    take the kernel on the card (the CPU named the card here); on the CPU
    every leaf takes the plain version."""
    pd, gd, md = dtypes
    p, g = torch.zeros(3, 4, dtype=pd), torch.zeros(3, 4, dtype=gd)
    m, v = torch.zeros(3, 4, dtype=md), torch.zeros(3, 4, dtype=md)
    lr = torch.zeros(())
    assert adam.takes_kernel(p, g, m, v, (lr, lr, lr), card="cpu") is True
    assert adam.takes_kernel(p, g, m, v, (lr, lr, lr)) is False


def _leaf(**change):
    """A (p, g, m, v) leaf and its scalars, fit for the kernel but for
    ``change``."""
    t = {"p": torch.zeros(3, 4), "g": torch.zeros(3, 4),
         "m": torch.zeros(3, 4), "v": torch.zeros(3, 4),
         "lr": torch.zeros(()), "bc1": torch.zeros(()),
         "bc2": torch.zeros(())}
    t.update(change)
    return (t["p"], t["g"], t["m"], t["v"]), (t["lr"], t["bc1"], t["bc2"])


@pytest.mark.parametrize("change, named", [
    ({"p": torch.zeros(3, 4, dtype=torch.float16)}, "p torch.float16 (3, 4)"),
    ({"p": torch.zeros(3, 4, dtype=torch.float64)}, "p torch.float64 (3, 4)"),
    ({"g": torch.zeros(3, 4, dtype=torch.float64)}, "g torch.float64 (3, 4)"),
    ({"g": torch.zeros(4, 3)}, "g torch.float32 (4, 3)"),
    ({"m": torch.zeros(3, 4, dtype=torch.bfloat16)},
     "m torch.bfloat16 (3, 4)"),
    ({"v": torch.zeros(12)}, "v torch.float32 (12,)"),
    ({"lr": torch.zeros(2)}, "lr torch.float32 (2,)"),
    ({"bc2": torch.zeros((), dtype=torch.float64)}, "bc2 torch.float64 ()"),
    ({"g": torch.zeros(3, 4, device="meta")}, "g torch.float32 (3, 4) on meta"),
])
def test_a_card_leaf_that_does_not_fit_raises(change, named):
    """On the card (the CPU named the card here) a leaf or scalar of
    another type, shape or device raises, naming its type, shape and
    device; nothing falls back to the plain version."""
    leaf, scalars = _leaf(**change)
    with pytest.raises(ValueError, match=re.escape(named)):
        adam.takes_kernel(*leaf, scalars, card="cpu")
    # on the CPU as it is: the plain version, whatever the types
    assert adam.takes_kernel(*leaf, scalars) is (
        leaf[0].device.type != "cpu")


def test_other_devices_raise():
    lr = torch.zeros(())
    meta = torch.zeros(3, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        adam.takes_kernel(meta, meta, meta, meta, ())
    with pytest.raises(ValueError, match="unsupported device"):
        adam.adam_dense([(meta, meta, meta, meta)], lr, lr, lr)


def _scalars(step: int):
    count = torch.tensor(step - 1, dtype=torch.int64)
    return optim.adam_scalars(
        count, optim.piecewise_constant((2,), (1e-2, 5e-3)))[1:]


def _tree(seed: int):
    gen = torch.Generator().manual_seed(seed)

    def a(*shape, dtype=torch.float32):
        return (torch.randn(shape, generator=gen) * 0.3).to(dtype)
    return {"w": a(6, 4), "b": a(4), "s": a(), "t": a(5, 3,
                                                       dtype=torch.bfloat16),
            "l": [{"w": a(3, 2)}, {"w": a(7, dtype=torch.bfloat16)}]}


def test_zip_leaves_and_map_leaves_visit_one_order():
    """``adam_update`` gathers the leaves with ``zip_leaves`` and rebuilds
    the trees with ``_map_leaves`` over the results in turn: both walk
    dicts by key order and lists by index, so each result lands on its
    own leaf."""
    params = _tree(0)
    grads = optim._map_leaves(lambda t: (t + 1,), 1, params)[0]
    pairs = optim.zip_leaves(params, grads)
    assert len(pairs) == 6
    assert all(torch.equal(g, p + 1) for p, g in pairs)
    it = iter(range(len(pairs)))
    numbered = optim._map_leaves(lambda _: (next(it),), 1, params)[0]
    flat = optim.zip_leaves(numbered)
    assert [x for (x,) in flat] == list(range(6))
    assert numbered["l"][1]["w"] == 5 and numbered["s"] == 2


def test_cpu_update_takes_the_plain_path_and_counts_it():
    """On the CPU every leaf takes the plain version, one by one, with the
    bits of ``adam_leaf_ref``; recorded, only ``optim.plain_leaves``."""
    opt = optim.make_optimizer(optim.DMTConfig(optimizer="adam",
                                               learning_rate=(1e-2, 5e-3),
                                               step_boundary=(2,)))
    params = _tree(0)
    state = opt.init(params)
    launches = adam.adam_dense.launches
    for step in range(1, 4):
        grads = _tree(step)
        lr, bc1, bc2 = _scalars(step)
        leaves = optim.zip_leaves(params, grads, state["m"], state["v"])
        want = adam.adam_dense_ref(leaves, lr, bc1, bc2)
        with tracing.recording():
            params, state = opt.update(params, grads, state)
        snap = tracing.snapshot()
        assert snap["counters"] == {"optim.plain_leaves": len(leaves)}
        got = optim.zip_leaves(params, state["m"], state["v"])
        for g3, w3 in zip(got, want):
            for x, y in zip(g3, w3):
                assert x.dtype == y.dtype and torch.equal(x, y)
        assert int(state["count"]) == step
    assert isinstance(params["l"], list) and params["l"][1]["w"].dtype == \
        torch.bfloat16
    assert adam.adam_dense.launches == launches


# ---------------------------------------------------------------------------
# The packed launches, run by a NumPy model of csrc/adam_dense.cu
# ---------------------------------------------------------------------------


def _mem(ptr: int, count: int, dtype) -> np.ndarray:
    """``count`` elements of ``dtype`` at host address ``ptr``, writable."""
    nbytes = count * np.dtype(dtype).itemsize
    buf = (ctypes.c_uint8 * max(nbytes, 1)).from_address(ptr)
    return np.frombuffer(buf, dtype=np.uint8)[:nbytes].view(dtype)


def _bf16_to_f32(u16: np.ndarray) -> np.ndarray:
    return (u16.astype(np.uint32) << 16).view(np.float32)


def _f32_to_bf16(f: np.ndarray) -> np.ndarray:
    bits = f.astype(np.float32).view(np.uint32)
    bias = ((bits >> 16) & 1) + np.uint32(0x7FFF)
    return ((bits + bias) >> 16).astype(np.uint16)


class KernelModel:
    """Runs a launch as the kernel does, block by block: the tile search
    over ``tile0``, each block's elements, and checks that a leaf marked
    for vector accesses is aligned for them."""

    def __init__(self):
        self.launches = []

    def __call__(self, chunk_ptr, tiles, tile, stream):
        assert tile == adam.TILE and stream == 0
        c = np.frombuffer(ctypes.string_at(chunk_ptr, 4096), adam.CHUNK)[0]
        self.launches.append((c, tiles))
        head, leaf = c["head"], c["leaf"]
        lr = _mem(int(head["lr"]), 1, np.float32)[0]
        bc1 = _mem(int(head["bc1"]), 1, np.float32)[0]
        bc2 = _mem(int(head["bc2"]), 1, np.float32)[0]
        c1, b1, c2, b2, eps = (np.float32(x) for x in head["c"])
        t0 = leaf["tile0"]
        assert (np.diff(t0.astype(np.int64)) >= 0).all()
        for b in range(tiles):
            k = int(np.searchsorted(t0, b, side="right")) - 1
            L = leaf[k]
            n = int(L["n"])
            lo = (b - int(L["tile0"])) * adam.TILE
            hi = min(lo + adam.TILE, n)
            assert 0 <= lo < hi, (b, k)
            kind = int(L["kind"])
            pt = np.uint16 if kind & adam.P_BF16 else np.float32
            gt = np.uint16 if kind & adam.G_BF16 else np.float32
            i = np.arange(lo, hi)
            if kind & adam.VECTOR:
                for name, t in (("p", pt), ("g", gt), ("m", np.float32),
                                ("v", np.float32), ("p_out", pt)):
                    assert int(L[name]) % (4 * np.dtype(t).itemsize) == 0
            p = _mem(int(L["p"]), n, pt)[i]
            g = _mem(int(L["g"]), n, gt)[i]
            m = _mem(int(L["m"]), n, np.float32)[i]
            v = _mem(int(L["v"]), n, np.float32)[i]
            p = _bf16_to_f32(p) if pt is np.uint16 else p
            g = _bf16_to_f32(g) if gt is np.uint16 else g
            m_new = c1 * g + b1 * m
            v_new = c2 * (g * g) + b2 * v
            # the kernel's square root is correctly rounded, as torch's on
            # the card; torch's float32 one on the CPU is not always, and
            # this model is held to the plain version on the CPU
            root = torch.sqrt(torch.from_numpy(v_new / bc2)).numpy()
            u = -lr * ((m_new / bc1) / (root + eps))
            if pt is np.uint16:
                p_new = _f32_to_bf16(p + _bf16_to_f32(_f32_to_bf16(u)))
            else:
                p_new = p + u
            out = int(L["out"])
            _mem(int(L["p_out"]), n, pt)[i] = p_new
            _mem(int(head["m_out"]) + 4 * out, n, np.float32)[i] = m_new
            _mem(int(head["v_out"]) + 4 * out, n, np.float32)[i] = v_new
        return 0


@pytest.fixture
def model(monkeypatch):
    """``adam_dense``'s launches on the CPU go to a ``KernelModel``."""
    km = KernelModel()

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(_build, "bind", lambda spec, args: km)
    monkeypatch.setattr(_build, "check", lambda spec, err, what: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(adam, "takes_kernel",
                        functools.partial(adam.takes_kernel, card="cpu"))
    return km


def _odd_leaves(gen):
    """(p, g) pairs of every shape the kernel must take: 0-dim, one
    element, sizes off the vector width, a leaf of many tiles, misaligned
    views, strided gradients (copied first), bfloat16."""
    def r(*shape, dtype=torch.float32):
        return (torch.randn(shape, generator=gen) * 0.5).to(dtype)
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
        wide = r(80, 240, dtype=dt)
        out.append((r(80, 80, dtype=dt), wide[:, 80:160]))
        odd = r(37, 6, dtype=dt)
        out.append((r(37, 3, dtype=dt), odd[:, 3:]))
        out.append((r(9, 4, dtype=dt), r(4, 9, dtype=dt).t()))
    out.append((r(5, 8, dtype=torch.bfloat16), r(5, 8)))
    return out


def test_packed_launches_match_the_plain_version(model):
    """Three steps over 130 leaves of every awkward shape (more than two
    launches' worth): the model of the kernel, run over the records the
    wrapper packed, gives the plain version's bits in p', m' and v'; the
    inputs are left as they were; the counters and launches are the
    plan's."""
    gen = torch.Generator().manual_seed(3)
    pairs = _odd_leaves(gen)
    pairs += [(torch.randn(17, 3, generator=gen),
               torch.randn(17, 3, generator=gen)) for _ in range(130 -
                                                                len(pairs))]
    state = [(p, torch.zeros(p.shape), torch.zeros(p.shape))
             for p, _ in pairs]
    n_real = sum(1 for p, _ in pairs if p.numel())
    for step in range(1, 4):
        lr, bc1, bc2 = _scalars(step)
        leaves = [(p, g, m, v) for (p, m, v), (_, g) in zip(state, pairs)]
        before = [[t.clone() for t in leaf] for leaf in leaves]
        want = adam.adam_dense_ref(leaves, lr, bc1, bc2)
        n0 = len(model.launches)
        with tracing.recording():
            got = adam.adam_dense(leaves, lr, bc1, bc2)
        counters = tracing.snapshot()["counters"]
        launches = -(-n_real // adam.MAX_LEAVES)
        assert len(model.launches) - n0 == launches == 3
        assert counters == {"optim.fused_leaves": len(leaves),
                            "optim.fused_launches": launches}
        for k, (g3, w3) in enumerate(zip(got, want)):
            for what, x, y in zip("pmv", g3, w3):
                assert x.dtype == y.dtype and x.shape == y.shape, (k, what)
                assert torch.equal(x, y), (step, k, what)
        for leaf, b in zip(leaves, before):
            assert all(torch.equal(x, y) for x, y in zip(leaf, b))
        state = [(p, m, v) for p, m, v in got]
    kinds = np.concatenate([c["leaf"]["kind"][:np.sum(
        c["leaf"]["tile0"] != adam.NO_TILE)] for c, _ in model.launches[:3]])
    # the first step's misaligned views take element accesses
    assert (kinds & adam.VECTOR).sum() > 0
    assert (~kinds & adam.VECTOR).sum() > 0
    assert ((kinds & adam.P_BF16) & ~(kinds & adam.G_BF16)).sum() > 0


def test_outputs_are_views_of_one_allocation(model):
    """p' (one allocation a dtype), m' and v' of every leaf lie in three or
    four fresh allocations, each leaf at a multiple of 4 elements."""
    gen = torch.Generator().manual_seed(5)
    leaves = []
    for shape, dt in (((3, 5), torch.float32), ((7,), torch.bfloat16),
                      ((), torch.float32), ((2, 2), torch.bfloat16)):
        p = torch.randn(shape, generator=gen).to(dt)
        leaves.append((p, torch.randn(shape, generator=gen).to(dt),
                       torch.zeros(shape), torch.zeros(shape)))
    lr, bc1, bc2 = _scalars(1)
    got = adam.adam_dense(leaves, lr, bc1, bc2)
    for j in range(3):
        bases = {t[j].untyped_storage().data_ptr() for t in got
                 if t[j].dtype == torch.float32}
        assert len(bases) == 1
    assert [t[1].storage_offset() for t in got] == [0, 16, 24, 28]
    assert [t[0].storage_offset() for t in got] == [0, 0, 16, 8]


def test_strided_operands_are_read_from_contiguous_copies(model):
    """A gradient cut from a wider product, and a transposed one, reach the
    kernel as contiguous copies, vector-aligned; the results are the plain
    version's."""
    gen = torch.Generator().manual_seed(7)
    wide = torch.randn(80, 240, generator=gen)
    tall = torch.randn(4, 9, generator=gen)
    leaves = [(torch.randn(80, 80, generator=gen), wide[:, 80:160]),
              (torch.randn(9, 4, generator=gen), tall.t())]
    leaves = [(p, g, torch.zeros(p.shape), torch.zeros(p.shape))
              for p, g in leaves]
    lr, bc1, bc2 = _scalars(1)
    got = adam.adam_dense(leaves, lr, bc1, bc2)
    want = adam.adam_dense_ref(leaves, lr, bc1, bc2)
    chunk, _ = model.launches[-1]
    recs = chunk["leaf"][:2]
    views = (wide.data_ptr(), tall.data_ptr())
    assert all(int(r["g"]) not in (v, v + 80 * 4) for r, v in
               zip(recs, views))
    assert (recs["kind"] & adam.VECTOR).all()
    for g3, w3 in zip(got, want):
        assert all(torch.equal(x, y) for x, y in zip(g3, w3))
