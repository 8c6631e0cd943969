"""Process groups and the (data x model) mesh
(``cikm2020_dmt_tpu/core/mesh.py``).

The JAX package runs one process over a ``(data x model)`` device mesh
and lets XLA insert the collectives.  The port runs one process per
device, joined by ``torch.distributed``:

- ``initialize_distributed`` starts the process group.  Its backend is
  explicit (a flag or the caller's argument, logged): ``nccl`` where each
  rank has a card of its own, ``gloo`` on the CPU or where ranks share a
  card.  Nothing tries one backend and then another.
- ``build_mesh`` gives this rank's ``Mesh``: the data and model sizes, the
  rank's data and model index, its device and its groups, with the JAX
  rule for the sizes (``mesh_data = 0`` fills the world).  Rank = data
  index x model + model index.  With ``mesh_model > 1`` every rank makes
  the subgroups with ``dist.new_group``, in the same order: the model
  group (the ranks of one data index, which hold the same batch rows) and
  the data group (the ranks of one model index, which hold the same
  shares of the model-split tables).
- ``param_placement`` says which param leaves are full-mesh tables (rows
  split over every rank, ``parallel/full_shard.py``), which are
  model-split (rows split over the model group,
  ``parallel/embedding_shard.py``) and which are replicated, by the test
  of JAX ``param_shardings``.
- ``Mesh.all_reduce``, ``all_to_all`` (equal splits), ``all_gather``,
  ``barrier``, ``agree`` and ``from_chief`` are the collectives the port
  uses, on tensors on the mesh's device: gloo takes card tensors for each
  of them and stages them through the host itself (checked on the H100).
  ``all_reduce`` and ``all_gather`` take ``axis="model"`` or ``"data"``
  for a subgroup; ``data_sum`` counts each data shard once.
  ``all_to_all`` and ``all_gather`` move 16-bit floats as their bytes,
  which every backend takes.
- ``model_axis_sum`` and ``model_axis_gather`` are the model group's
  differentiable collectives.  Model peers run the same forward on the
  same rows, so each already holds the whole cotangent: the sum's
  backward is the identity and the gather's takes the rank's own block
  (JAX's ``psum`` and tiled ``all_gather`` under ``shard_map``).
- ``active(mesh)`` marks the mesh of the training step in progress: batch
  norm then takes the global batch's statistics (``nn/layers.py``).
"""

from __future__ import annotations

import contextlib
import datetime
import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from .config import DMTConfig
from .logging import log_line

BACKENDS = ("nccl", "gloo")
AXES = (None, "model", "data")


def default_backend(device) -> str:
    """``gloo`` for CPU ranks, ``nccl`` for ranks on cards: the flag's
    default, which assumes one card per rank (ranks that share a card
    pass ``gloo``)."""
    return "gloo" if torch.device(device).type == "cpu" else "nccl"


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: str = "nccl",
                           init_method: Optional[str] = None) -> bool:
    """Joins the process group; a no-op (False) for one process.

    ``num_processes`` defaults to ``$DMT_NUM_PROCESSES`` (1).  The group
    meets at ``init_method``, default ``tcp://{coordinator}`` (host:port of
    process 0)."""
    if num_processes is None:
        num_processes = int(os.environ.get("DMT_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return False
    if backend not in BACKENDS:
        raise ValueError(f"distributed backend {backend!r}: one of "
                         f"{BACKENDS}")
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id}: each of the "
                         f"{num_processes} processes needs its id in "
                         f"[0, {num_processes})")
    if init_method is None:
        if not coordinator:
            raise ValueError("several processes need --coordinator "
                             "host:port (process 0's address)")
        init_method = f"tcp://{coordinator}"
    _join(backend, init_method, num_processes, process_id, None)
    return True


def _join(backend: str, init_method: str, n: int, rank: int,
          timeout_s: Optional[float]) -> None:
    """``init_process_group``; ``timeout_s`` bounds every collective (the
    torch default otherwise): a rank that waits longer raises."""
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=n, rank=rank, **kw)
    if rank == 0:
        log_line(f"process group: {n} processes, backend {backend}, at "
                 f"{init_method}")


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_chief() -> bool:
    """Rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


@dataclass
class Mesh:
    """This rank's view of the (data x model) mesh: one process per
    device, rank = data_index * model + model_index."""
    data: int
    model: int
    rank: int
    device: torch.device
    backend: str
    group: object = None          # None: the default group
    model_group: object = None    # the ranks of this data index
    data_group: object = None     # the ranks of this model index

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def _group(self, axis: Optional[str]) -> tuple[object, int]:
        """(group, ranks) of ``axis``: None every rank, ``"model"`` the
        model group, ``"data"`` the data group."""
        if axis is None:
            return self.group, self.size
        if axis == "model":
            return self.model_group, self.model
        if axis == "data":
            return (self.data_group if self.model > 1 else self.group,
                    self.data)
        raise ValueError(f"mesh axis {axis!r}: one of {AXES}")

    # -- collectives --------------------------------------------------
    def all_reduce(self, t: torch.Tensor, op: str = "sum",
                   axis: Optional[str] = None) -> torch.Tensor:
        """``t`` reduced over the ranks of ``axis`` (None: every rank), in
        place; returns ``t``.  Takes 32- and 64-bit types (cast 16-bit
        floats first)."""
        if t.dtype in (torch.bfloat16, torch.float16):
            raise TypeError(f"all_reduce: {t.dtype}; reduce in float32")
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        group, n = self._group(axis)
        if axis is None or n > 1:
            dist.all_reduce(t, red, group=group)
        return t

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Block i of ``t`` (the leading dim split in ``size`` equal
        blocks) goes to rank i; block j of the result came from rank j."""
        if t.shape[0] % self.size:
            raise ValueError(f"all_to_all: {t.shape[0]} rows do not split "
                             f"in {self.size} equal blocks")
        bits = t.dtype in (torch.bfloat16, torch.float16)
        src = t.contiguous()
        if bits:
            src = src.view(torch.uint8)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group)
        return out.view(t.dtype) if bits else out

    def all_gather(self, t: torch.Tensor,
                   axis: Optional[str] = None) -> torch.Tensor:
        """[n, *t.shape]: the ``t`` of each of the n ranks of ``axis``
        (None: every rank) in rank order."""
        group, n = self._group(axis)
        if axis is not None and n == 1:
            return t[None]
        bits = t.dtype in (torch.bfloat16, torch.float16)
        src = t.contiguous()
        if bits:
            src = src.view(torch.uint8)
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        out = torch.stack(parts)
        return out.view(t.dtype) if bits else out

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)

    def agree(self, *flags: bool) -> tuple[bool, ...]:
        """Each flag true on every rank when it is true on any (one
        ``all_reduce`` and a host read)."""
        t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32,
                         device=self.device)
        return tuple(bool(v) for v in self.all_reduce(t, "max").tolist())

    def from_chief(self, *flags: bool) -> tuple[bool, ...]:
        """Rank 0's flags on every rank (one ``broadcast`` and a host
        read): a decision taken once, where ranks could see otherwise."""
        t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32,
                         device=self.device)
        dist.broadcast(t, 0, group=self.group)
        return tuple(bool(v) for v in t.tolist())

    def reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """A new tensor: ``t`` summed over every rank (``t`` unchanged)."""
        return self.all_reduce(t.clone())

    def data_sum(self, t: torch.Tensor) -> torch.Tensor:
        """A new tensor: ``t`` summed over the data shards, each counted
        once (the copies of model index 0; model peers hold the same batch
        rows), the same bits on every rank."""
        mine = t.clone() if self.model_index == 0 else torch.zeros_like(t)
        return self.all_reduce(mine)


def build_mesh(cfg: DMTConfig, world: Optional[int] = None, device=None,
               rank: Optional[int] = None) -> Mesh:
    """This rank's mesh over the process group's ``world`` ranks.

    ``mesh_data`` 0 means every rank not used by the model axis; data x
    model must cover the world.  The device is ``device``; ``cuda`` without
    an index (the default) is ``cuda:(rank % device_count)``.  A CUDA device
    without CUDA raises.  With ``mesh_model > 1`` every rank makes the
    model and data groups (collectives of the process group)."""
    model = max(1, cfg.mesh_model)
    world = world if world is not None else world_size()
    rank = rank if rank is not None else (
        dist.get_rank() if dist.is_initialized() else 0)
    data = cfg.mesh_data if cfg.mesh_data > 0 else world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} does not cover {world} "
                         "processes")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("build_mesh: no CUDA card; pass device='cpu' "
                               "for CPU ranks")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"build_mesh: device {device} requested but CUDA "
                           "is not available")
    backend = dist.get_backend() if dist.is_initialized() else "gloo"
    if world > 1 and not dist.is_initialized():
        raise RuntimeError("build_mesh: a mesh over several processes needs "
                           "initialize_distributed first")
    mesh = Mesh(data, model, rank, device, backend)
    if model > 1:
        # every rank makes every group, in the same order
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if d == mesh.data_index:
                mesh.model_group = g
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if m == mesh.model_index:
                mesh.data_group = g
    return mesh


def param_placement(cfg: DMTConfig, params: dict, mesh: Mesh) -> dict:
    """``params``' tree with each leaf replaced by ``"full_mesh"`` (a
    table whose rows split over every rank), ``"model_split"`` (a table of
    the main or bias-net collection whose rows split over the model group,
    ``embedding_shard.model_split_tables``) or ``"replicated"``."""
    from ..parallel.embedding_shard import model_split_tables
    from ..parallel.full_shard import fms_table_rows
    fms = fms_table_rows(cfg, mesh.size)
    split = model_split_tables(cfg, mesh.size, mesh.model)
    bias = params.get("bias_net", {}).get("emb")

    def place(tree, table=None):
        if isinstance(tree, dict):
            return {k: place(v, k if tree is params.get("emb")
                             else "bias:" + k if tree is bias else None)
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [place(v) for v in tree]
        if getattr(tree, "ndim", 0) == 2:
            if table in fms:
                return "full_mesh"
            if table in split:
                return "model_split"
        return "replicated"

    return place(params)


# ---------------------------------------------------------------------------
# The mesh of the step in progress
# ---------------------------------------------------------------------------

_ACTIVE: Optional[Mesh] = None


@contextlib.contextmanager
def active(mesh: Optional[Mesh]):
    """Marks ``mesh`` (None: no mesh) as the mesh of the step in progress
    for the layers that read it (``current``)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mesh
    try:
        yield mesh
    finally:
        _ACTIVE = prev


def current() -> Optional[Mesh]:
    """The active mesh when it spans more than one rank, else None."""
    return _ACTIVE if _ACTIVE is not None and _ACTIVE.size > 1 else None


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose backward is the sum of the ranks'
    cotangents (each rank differentiates its share of the global loss)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return mesh.reduce_sum(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_sum(g.contiguous()), None


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Differentiable sum of ``t`` over every rank of ``mesh``."""
    return _AllReduceSum.apply(t, mesh)


class _ModelAxisSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t, mesh):
        return mesh.all_reduce(t.float().clone(), axis="model").to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def model_axis_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` summed over the model group (in float32, cast back), whose
    backward is the identity: each model peer holds the whole cotangent."""
    if mesh.model == 1:
        return t
    return _ModelAxisSum.apply(t, mesh)


class _ModelAxisGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return mesh.all_gather(t, axis="model")

    @staticmethod
    def backward(ctx, g):
        return g[ctx.mesh.model_index], None


def model_axis_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[model, *t.shape]: each model peer's ``t`` in order, whose backward
    is the rank's own block of the cotangent."""
    return _ModelAxisGather.apply(t, mesh)


# ---------------------------------------------------------------------------
# Ranks on one machine
# ---------------------------------------------------------------------------


def _rank_main(fn, rank: int, n: int, backend: Optional[str],
               workdir: str, timeout_s: float,
               threads: Optional[int]) -> None:
    import traceback
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        args = torch.load(os.path.join(workdir, "args.pt"),
                          weights_only=False)
        if backend is not None:
            _join(backend, f"file://{workdir}/store", n, rank, timeout_s)
        out = fn(rank, *args)
        torch.save(out, os.path.join(workdir, f"out{rank}.pt"))
        if dist.is_initialized():
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(workdir, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn, n: int, *args, backend: Optional[str] = "gloo",
              timeout_s: float = 600.0, threads: Optional[int] = None,
              workdir: Optional[str] = None) -> list:
    """``fn(rank, *args)`` in ``n`` spawned processes joined in one process
    group (a ``file://`` store in ``workdir``, default a temporary
    directory; ``backend`` None: ``fn`` joins one itself); returns each
    rank's result in rank order.  ``fn`` must be
    importable by name; ``args`` and the results travel as ``torch.save``
    files.  Any rank's exception, or a rank still running after
    ``timeout_s``, stops every rank and raises."""
    import multiprocessing
    import tempfile
    import time
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        torch.save(args, os.path.join(tmp, "args.pt"))
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, n, backend, tmp, timeout_s,
                                   threads))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.is_alive() for p in procs):
                failed = [r for r, p in enumerate(procs)
                          if p.exitcode not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        errors = []
        for r, p in enumerate(procs):
            path = os.path.join(tmp, f"error{r}.txt")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0:
                errors.append(f"rank {r}: exit code {p.exitcode}"
                              + (" (stopped)" if p.exitcode < 0 else ""))
        if errors:
            raise RuntimeError(f"run_ranks({getattr(fn, '__name__', fn)}, "
                               f"{n}): " + "\n".join(errors))
        return [torch.load(os.path.join(tmp, f"out{r}.pt"),
                           weights_only=False) for r in range(n)]
