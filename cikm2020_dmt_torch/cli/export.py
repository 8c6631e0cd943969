"""Export entry point: bundle a checkpoint for serving.

    python -m cikm2020_dmt_torch.cli.export --conf_file conf/dmt.conf \
        --model_ckpt model.ckpt-150000

Replaces ``python rec_saved_model.py --conf_file=... --model_ckpt=...``
(reference rec_saved_model.py:28-39).  The export runs on the host:
``--device`` is not read.  ``export_int8_rows`` in the config's
``[export_model]`` section ships the large tables as int8.
"""

from __future__ import annotations

from ..serve.export import export_model
from .args import build_parser, ckpt_step, load_config


def main(argv=None) -> str:
    """Exports as the flags say; returns the bundle's directory."""
    args = build_parser("DMT serving export").parse_args(argv)
    cfg = load_config(args)
    out = export_model(cfg, ckpt_step(args.model_ckpt))
    print(f"Successfully exported model to {out}")
    return out


if __name__ == "__main__":
    main()
