"""Seeded weights of a configuration, made by the benchmark: the plain
reference's layout (``reference/model.layout``), drawn on the device in
one call of a ``torch.Generator`` and cut into leaves, each in the type
it is stored in.  Both sides of a run get the same weights: the program
as a copy into its own tree, the reference as made here."""

from __future__ import annotations

import math

import torch

from . import seeds
from .reference import model

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make(conf, seed: int, device) -> dict:
    """The parameter tree of ``conf`` for run ``seed`` on ``device``:
    uniform leaves in [-limit, limit], constant leaves filled."""
    spec = model.layout(conf)
    total = sum(math.prod(shape) for _, shape, _, init in spec
                if init[0] == "uniform")
    gen = torch.Generator(device=device).manual_seed(
        seeds.derive(seed, seeds.WEIGHTS))
    flat = torch.rand(total, generator=gen, device=device)
    tree: dict = {}
    off = 0
    for path, shape, dtype, init in spec:
        if init[0] == "uniform":
            n = math.prod(shape)
            leaf = (flat[off:off + n].view(shape) * (2.0 * init[1])
                    - init[1]).to(_DTYPES[dtype])
            off += n
        else:
            leaf = torch.full(shape, init[1], dtype=_DTYPES[dtype],
                              device=device)
        model.tree_set(tree, path, leaf)
    del flat
    return tree


def copy_into(dst, src, path=()) -> None:
    """Copies every leaf of ``src`` into the same leaf of the program's
    tree ``dst`` (its tensors keep their identity, type and device);
    a leaf that either tree lacks, or of another shape, raises."""
    if isinstance(src, dict):
        if not isinstance(dst, dict) or set(dst) != set(src):
            raise ValueError(f"parameter tree differs at {path}: program "
                             f"{sorted(dst) if isinstance(dst, dict) else type(dst)}"
                             f", benchmark {sorted(src)}")
        for k in src:
            copy_into(dst[k], src[k], path + (k,))
    elif isinstance(src, list):
        if not isinstance(dst, (list, tuple)) or len(dst) != len(src):
            raise ValueError(f"parameter tree differs at {path}")
        for i, v in enumerate(src):
            copy_into(dst[i], v, path + (i,))
    else:
        if tuple(dst.shape) != tuple(src.shape) or dst.dtype != src.dtype:
            raise ValueError(f"leaf {path}: program {tuple(dst.shape)} "
                             f"{dst.dtype}, benchmark {tuple(src.shape)} "
                             f"{src.dtype}")
        with torch.no_grad():
            dst.copy_(src)
