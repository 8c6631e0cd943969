"""Chief training entry point.

    python -m cikm2020_dmt_torch.cli.train --conf_file conf/dmt.conf \
        [--model_ckpt model.ckpt-N] [--max_steps K] [--device cpu]

On several devices, one process each (a data mesh, ``core/mesh.py``):

    python -m cikm2020_dmt_torch.cli.train --conf_file conf/dmt.conf \
        --num_processes N --process_id K --coordinator host:port \
        [--dist_backend nccl|gloo]

Replaces ``TF_CONFIG={'task':{'type':'chief'}} python run_dnn.py``
(reference train.sh:8-11, run_dnn.py:900-918).
"""

from __future__ import annotations

from ..core.logging import log_line
from ..core.mesh import build_mesh, is_chief, world_size
from ..train.loop import Trainer
from .args import (build_parser, ckpt_step, load_config,
                   maybe_init_distributed)


def main(argv=None) -> Trainer:
    """Trains as the flags say; returns the trainer (its ``last_step`` and
    ``state`` after the run)."""
    args = build_parser("DMT training (chief role), on one device or one "
                        "process per device").parse_args(argv)
    maybe_init_distributed(args)
    cfg = load_config(args)
    resume = ckpt_step(args.model_ckpt)
    mesh = None
    if world_size() > 1:
        mesh = build_mesh(cfg, device=args.device)
    trainer = Trainer(cfg, device=args.device, mesh=mesh)
    if is_chief():
        ranks = f" x {mesh.data} ranks ({mesh.backend})" if mesh else ""
        log_line(f"training {cfg.model_type} | conf {cfg.tag} | "
                 f"batch {cfg.batch_size}{ranks} | device "
                 f"{trainer.device} | resume step {resume}")
    vals = trainer.train(max_steps=args.max_steps,
                         resume_step=resume if resume > 0 else None,
                         log_every=args.log_every)
    if is_chief():
        log_line("final train metrics: " + " | ".join(
            f"{k} {v:.6f}" for k, v in vals.items()))
    return trainer


if __name__ == "__main__":
    main()
    if world_size() > 1:
        import torch.distributed as dist
        dist.destroy_process_group()
