"""Chief training entry point.

    python -m cikm2020_dmt_torch.cli.train --conf_file conf/dmt.conf \
        [--model_ckpt model.ckpt-N] [--max_steps K] [--device cpu]

Replaces ``TF_CONFIG={'task':{'type':'chief'}} python run_dnn.py``
(reference train.sh:8-11, run_dnn.py:900-918).
"""

from __future__ import annotations

from ..core.logging import log_line
from ..train.loop import Trainer
from .args import (build_parser, ckpt_step, load_config,
                   maybe_init_distributed)


def main(argv=None) -> Trainer:
    """Trains as the flags say; returns the trainer (its ``last_step`` and
    ``state`` after the run)."""
    args = build_parser("DMT training on one device (chief role)"
                        ).parse_args(argv)
    maybe_init_distributed(args)
    cfg = load_config(args)
    resume = ckpt_step(args.model_ckpt)
    trainer = Trainer(cfg, device=args.device)
    log_line(f"training {cfg.model_type} | conf {cfg.tag} | "
             f"batch {cfg.batch_size} | device {args.device} | "
             f"resume step {resume}")
    vals = trainer.train(max_steps=args.max_steps,
                         resume_step=resume if resume > 0 else None,
                         log_every=args.log_every)
    log_line("final train metrics: " + " | ".join(
        f"{k} {v:.6f}" for k, v in vals.items()))
    return trainer


if __name__ == "__main__":
    main()
