"""The dense Adam step of many leaves at once: ``csrc/adam_dense.cu``.

``adam_dense(leaves, lr, bc1, bc2)`` takes (p, g, m, v) tuples, one a
leaf, and returns the (p', m', v') of each as new tensors (the inputs are
not modified): optax's ``f32_math(adam)`` step, float32 moments whatever
the parameter's type, float32 update math, and for a bfloat16 parameter
the update rounded to its type and then added in that type, two roundings.
``lr``, ``bc1`` and ``bc2`` are float32 scalars on the leaves' device (the
rate and the two bias corrections of this step).

A leaf on the CPU takes the plain version ``adam_leaf_ref`` (one PyTorch
operation at a time).  A leaf on the card takes the kernel, and must fit
it (``takes_kernel``): p and g float32 or bfloat16, m and v float32 of
p's shape, the scalars float32 of one element, all on p's card; a card
leaf that does not fit, or a leaf on any other device, raises.  The
card's leaves go into launches of up to ``MAX_LEAVES`` leaves, each passed
by value as one 4 KB kernel parameter block (``CHUNK``), and their p', m'
and v' are views into one fresh allocation of each (one for p' a dtype).
The kernel replaces no TPU kernel: the JAX package leaves this step to XLA.

Under ``core.tracing.recording()`` a call counts ``optim.fused_leaves``
and ``optim.fused_launches`` (leaves and launches the kernel took) and
``optim.plain_leaves`` (leaves on the CPU); ``adam_dense.launches``
counts the launches always, as the other kernels' wrappers do.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import tracing
from . import _build

B1, B2, EPS = 0.9, 0.999, 1e-8  # TF1 AdamOptimizer defaults

KERNEL = "adam_dense"
TILE = 2048         # elements a block (the kernel's kTile; the launcher
                    # refuses any other)
MAX_LEAVES = 63     # leaves a launch (kMaxLeaves)
VEC = 4             # elements of one vector access
NO_TILE = 2 ** 31 - 1   # tile0 of an unused slot
# a leaf's kind bits
P_BF16, G_BF16, VECTOR = 1, 2, 4
TYPES = (torch.float32, torch.bfloat16)

# csrc/adam_dense.cu's Leaf and Chunk, byte for byte
LEAF = np.dtype([("p", "<u8"), ("g", "<u8"), ("m", "<u8"), ("v", "<u8"),
                 ("p_out", "<u8"), ("out", "<i8"), ("n", "<i8"),
                 ("tile0", "<i4"), ("kind", "<i4")])
HEAD = np.dtype([("lr", "<u8"), ("bc1", "<u8"), ("bc2", "<u8"),
                 ("m_out", "<u8"), ("v_out", "<u8"), ("c", "<f4", (5,)),
                 ("pad", "<i4")])
CHUNK = np.dtype([("head", HEAD), ("leaf", LEAF, (MAX_LEAVES,))])

_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
# chunk tiles tile stream
_ARGS = (_PTR, _I32, _I32, _PTR)


def constants() -> np.ndarray:
    """(1 - b1, b1, 1 - b2, b2, eps) as the float32 values torch gives the
    Python scalars in ``adam_leaf_ref`` (a scalar operand of a float32
    tensor is rounded once to float32)."""
    return np.array([1.0 - B1, B1, 1.0 - B2, B2, EPS], dtype=np.float32)


def adam_leaf_ref(p, g, m, v, lr, bc1, bc2):
    """Plain version: one leaf's (p', m', v')."""
    g32 = g.float()
    m_new = (1.0 - B1) * g32 + B1 * m
    v_new = (1.0 - B2) * (g32 * g32) + B2 * v
    u = (-lr) * ((m_new / bc1) / (torch.sqrt(v_new / bc2) + EPS))
    return p + u.to(p.dtype), m_new, v_new


def adam_dense_ref(leaves, lr, bc1, bc2) -> list:
    """Plain version of ``adam_dense``: every leaf by ``adam_leaf_ref``."""
    return [adam_leaf_ref(p, g, m, v, lr, bc1, bc2) for p, g, m, v in leaves]


def takes_kernel(p, g, m, v, scalars=(), card: str = "cuda") -> bool:
    """Whether a leaf takes the kernel: False on the CPU, True on the card
    (device type ``card``) where it fits: p and g float32 or bfloat16, m,
    v and the step's scalars (lr, bc1, bc2) float32, g, m and v of p's
    shape, the scalars of one element, all on p's device.  A card leaf
    that does not fit raises, naming what does not; so does a leaf on any
    other device."""
    dev = p.device
    if dev.type != card:
        if dev.type == "cpu":
            return False
        raise ValueError(f"adam_dense: unsupported device {dev}")
    checks = [("p", p, p.dtype in TYPES),
              ("g", g, g.dtype in TYPES and g.shape == p.shape),
              ("m", m, m.dtype == torch.float32 and m.shape == p.shape),
              ("v", v, v.dtype == torch.float32 and v.shape == p.shape)]
    checks += [(name, s, s.dtype == torch.float32 and s.numel() == 1)
               for name, s in zip(("lr", "bc1", "bc2"), scalars)]
    bad = [f"{name} {t.dtype} {tuple(t.shape)} on {t.device}"
           for name, t, ok in checks if not ok or t.device != dev]
    if bad:
        raise ValueError(
            f"adam_dense: a leaf on {dev} does not fit the kernel (p and g "
            "float32 or bfloat16; m, v, lr, bc1, bc2 float32; g, m, v of "
            f"p's shape {tuple(p.shape)}; scalars of one element; all on "
            f"{dev}): " + ", ".join(bad))
    return True


def plan(sizes) -> list:
    """The launches for leaves of ``sizes`` elements, in order: a list of
    (leaf indices, first tile of each, tiles) with at most ``MAX_LEAVES``
    leaves a launch; leaves of no element are left out."""
    out = []
    idx, tile0, tiles = [], [], 0
    for i, n in enumerate(sizes):
        if n == 0:
            continue
        if len(idx) == MAX_LEAVES:
            out.append((idx, tile0, tiles))
            idx, tile0, tiles = [], [], 0
        idx.append(i)
        tile0.append(tiles)
        tiles += -(-n // TILE)
    if idx:
        out.append((idx, tile0, tiles))
    return out


def _padded(n: int) -> int:
    return -(-n // VEC) * VEC


def adam_dense(leaves, lr, bc1, bc2) -> list:
    """The (p', m', v') of each (p, g, m, v) of ``leaves``, in order: the
    kernel for the card's leaves, the plain version for the CPU's
    (``takes_kernel``)."""
    out = [None] * len(leaves)
    scalars = (lr, bc1, bc2)
    card = []
    for i, (p, g, m, v) in enumerate(leaves):
        if takes_kernel(p, g, m, v, scalars):
            card.append(i)
        else:
            out[i] = adam_leaf_ref(p, g, m, v, lr, bc1, bc2)
    if card:
        launches = _fused(card, leaves, lr, bc1, bc2, out)
        tracing.count("optim.fused_leaves", len(card))
        tracing.count("optim.fused_launches", launches)
    if len(card) < len(leaves):
        tracing.count("optim.plain_leaves", len(leaves) - len(card))
    return out


adam_dense.launches = 0


def _kind(p, g, ptrs) -> int:
    """A leaf's kind bits from its contiguous operands and their addresses
    (p, g, m, v)."""
    kind = ((P_BF16 if p.dtype == torch.bfloat16 else 0)
            | (G_BF16 if g.dtype == torch.bfloat16 else 0))
    widths = (VEC * p.element_size(), VEC * g.element_size(), 4 * VEC,
              4 * VEC)
    vec = all(a % w == 0 for a, w in zip(ptrs, widths))
    return kind | (VECTOR if vec else 0)


def _fused(idx, leaves, lr, bc1, bc2, out) -> int:
    """Launches the kernel on the leaves ``idx`` (on ``lr``'s card) and
    puts their results into ``out``; returns the launches."""
    dev = lr.device
    ins = [tuple(t if t.is_contiguous() else t.contiguous()
                 for t in leaves[i]) for i in idx]
    sizes = [t[0].numel() for t in ins]
    # m' and v' in one allocation each, p' in one a dtype, every leaf at a
    # multiple of VEC elements (so each output is aligned for vectors)
    offs, p_offs, total, p_len = [], [], 0, {dt: 0 for dt in TYPES}
    for (p, *_), n in zip(ins, sizes):
        offs.append(total)
        p_offs.append(p_len[p.dtype])
        total += _padded(n)
        p_len[p.dtype] += _padded(n)
    m_flat = torch.empty(total, dtype=torch.float32, device=dev)
    v_flat = torch.empty(total, dtype=torch.float32, device=dev)
    p_flat = {dt: torch.empty(p_len[dt], dtype=dt, device=dev)
              for dt in {t[0].dtype for t in ins}}
    p_out = []
    for k, (p, *_) in enumerate(ins):
        shape, stride = p.shape, p.stride()
        p_new = torch.as_strided(p_flat[p.dtype], shape, stride, p_offs[k])
        out[idx[k]] = (p_new,
                       torch.as_strided(m_flat, shape, stride, offs[k]),
                       torch.as_strided(v_flat, shape, stride, offs[k]))
        p_out.append(p_new.data_ptr())
    ptrs = [tuple(x.data_ptr() for x in t) for t in ins]
    rec = np.zeros(len(ins), LEAF)
    for j, name in enumerate(("p", "g", "m", "v")):
        rec[name] = [a[j] for a in ptrs]
    rec["p_out"], rec["out"], rec["n"] = p_out, offs, sizes
    rec["kind"] = [_kind(t[0], t[1], a) for t, a in zip(ins, ptrs)]

    chunk = np.zeros((), CHUNK)
    head = chunk["head"]
    head["lr"], head["bc1"], head["bc2"] = (lr.data_ptr(), bc1.data_ptr(),
                                            bc2.data_ptr())
    head["m_out"], head["v_out"] = m_flat.data_ptr(), v_flat.data_ptr()
    head["c"] = constants()
    slots = chunk["leaf"]
    launch = _build.bind(KERNEL, _ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launches = plan(sizes)
    with torch.cuda.device(dev):
        for ks, tile0, tiles in launches:
            slots[:] = 0
            slots["tile0"] = NO_TILE
            slots[:len(ks)] = rec[ks]
            slots["tile0"][:len(ks)] = tile0
            err = launch(chunk.ctypes.data, tiles, TILE, stream)
            _build.check(KERNEL, err, f"{len(ks)} leaves, {tiles} tiles")
    adam_dense.launches += len(launches)
    return len(launches)


def adam_bytes(leaves) -> int:
    """Bytes of one step, for the bound: p, g, m and v of every leaf read
    once, p, m and v written once."""
    return sum(p.numel() * (2 * p.element_size() + g.element_size() + 16)
               for p, g, _, _ in leaves)
