"""Test/predict entry point: score a test split with a named checkpoint.

    python -m cikm2020_dmt_torch.cli.test --conf_file conf/dmt.conf \
        --model_ckpt model.ckpt-150000 --test_tag ord \
        --test_score_method rel [--grid_search] [--device cpu]

Replaces ``python run_dnn.py --is_test=true ...`` (reference test.sh:10,
run_dnn.py:635-897).  Prints one JSON line per test path.
"""

from __future__ import annotations

import json

from ..train.evaluate import predict
from .args import build_parser, ckpt_step, load_config


def main(argv=None) -> dict:
    """Scores as the flags say; returns ``predict``'s results by path."""
    parser = build_parser("DMT test/predict on one device")
    parser.add_argument("--grid_search", action="store_true",
                        help="metrics2-style blend-weight sweep")
    args = parser.parse_args(argv)
    cfg = load_config(args)
    results = predict(cfg, ckpt_step(args.model_ckpt),
                      test_tag=args.test_tag,
                      test_score_method=args.test_score_method,
                      grid_search=args.grid_search, device=args.device)
    for path, r in results.items():
        print(json.dumps({
            "path": path,
            "overall_auc": r["overall_auc"],
            "grouped_auc": {str(k): v for k, v in r["grouped_auc"].items()},
            "streaming": r["streaming"],
        }))
    return results


if __name__ == "__main__":
    main()
