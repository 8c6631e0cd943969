"""Evaluator entry point: poll checkpoints, evaluate each new one.

    python -m cikm2020_dmt_torch.cli.valid --conf_file conf/dmt.conf \
        [--once] [--device cpu]

Replaces ``TF_CONFIG={'task':{'type':'evaluator'}} python run_dnn.py``
(reference valid.sh:7-10, run_dnn.py:432-632).
"""

from __future__ import annotations

from typing import Optional

from ..train.evaluate import validation
from .args import build_parser, load_config


def main(argv=None) -> Optional[dict]:
    """Evaluates as the flags say; returns the last checkpoint's streaming
    metric values (None when there was none to evaluate)."""
    parser = build_parser("DMT validation on one device (evaluator role)")
    parser.add_argument("--once", action="store_true",
                        help="evaluate at most one new checkpoint and exit")
    args = parser.parse_args(argv)
    cfg = load_config(args)
    return validation(cfg, once=args.once, max_steps=args.max_steps,
                      device=args.device)


if __name__ == "__main__":
    main()
