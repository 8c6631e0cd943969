"""Shared command-line flags (the JAX package's ``cli/args.py``, the
reference's parse/parse.py flags) and what the entry points derive from
them."""

from __future__ import annotations

import argparse
import glob
import os

from ..core.config import DMTConfig


def build_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--conf_path", default="./conf/",
                   help="config directory (reference parse.py)")
    p.add_argument("--conf_file", default="dmt.conf",
                   help="config file name, or a full path")
    p.add_argument("--model_ckpt", default="model.ckpt-0",
                   help="checkpoint name model.ckpt-<step>")
    p.add_argument("--test_tag", default="", choices=["", "clk", "ord"],
                   help="test split selector")
    p.add_argument("--test_score_method", default="rel",
                   choices=["rel", "ctr"],
                   help="rel = relevance-only scores; ctr = bias-combined")
    p.add_argument("--max_steps", type=int, default=None,
                   help="override max_iter_step")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device: the card by default, cpu for the "
                        "plain PyTorch path")
    # several processes, one per device (a data mesh); one process when
    # omitted
    p.add_argument("--num_processes", type=int, default=None,
                   help="processes in all (default $DMT_NUM_PROCESSES, 1)")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's rank in [0, num_processes)")
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0")
    p.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"],
                   help="nccl (one card per process; the default on the "
                        "card) or gloo (the CPU, the default there, or "
                        "processes that share a card)")
    return p


def maybe_init_distributed(args: argparse.Namespace) -> bool:
    """Joins the process group when the flags (or $DMT_NUM_PROCESSES) ask
    for more than one process (``core.mesh.initialize_distributed``);
    True when it did."""
    from ..core.mesh import default_backend, initialize_distributed
    backend = args.dist_backend or default_backend(args.device)
    return initialize_distributed(coordinator=args.coordinator,
                                  num_processes=args.num_processes,
                                  process_id=args.process_id,
                                  backend=backend)


def load_config(args: argparse.Namespace, **overrides) -> DMTConfig:
    path = args.conf_file
    if not os.path.exists(path):
        path = os.path.join(args.conf_path, args.conf_file)
    cfg = DMTConfig.from_ini(path, **overrides)
    return apply_label_stats(cfg)


def apply_label_stats(cfg: DMTConfig) -> DMTConfig:
    """Caps the step budget from the train label-count stat file
    (reference recsys_conf.py:139-151: one count per line; examples = their
    sum; max_iter_step = epochs x examples / (batch x data ranks), the data
    ranks being the processes of the group)."""
    from ..core.mesh import world_size
    path = cfg.train_data_stat_path
    if not path:
        return cfg
    candidates = [path] if os.path.isfile(path) else \
        sorted(glob.glob(os.path.join(path, "part-*")) +
               glob.glob(os.path.join(path, "stat*")))
    for cand in candidates:
        try:
            with open(cand) as f:
                counts = tuple(int(line.strip()) for line in f
                               if line.strip())
            if counts:
                return cfg.recompute_max_steps(
                    counts, num_replicas=world_size())
        except (OSError, ValueError):
            continue
    return cfg


def ckpt_step(name: str) -> int:
    """Step from a model.ckpt-<N> name (reference run_dnn.py:119-122);
    'current'/'0' -> 0."""
    if "-" not in name:
        return 0
    try:
        return int(name.rsplit("-", 1)[1])
    except ValueError:
        return 0
