"""Training-summary plots: JSONL scalars -> small-multiple PNG + CSV (the
port's own copy of ``cikm2020_dmt_tpu/cli/plot.py``; matplotlib is
imported only by ``plot_runs``).

Fills the reference's TensorBoard role (reference run_dnn.py:243-256,
514-523): core.logging.SummaryWriter records train/validation scalars as
JSONL; this renders one line chart per metric (train + validation overlaid
vs step) and a tidy CSV for spreadsheet use.

    python -m cikm2020_dmt_torch.cli.plot --conf_file conf/dmt_demo.conf
    python -m cikm2020_dmt_torch.cli.plot --summary_dir out/x/summary
"""

from __future__ import annotations

import argparse
import csv
import json
import os

# categorical slots 1/2 of the validated reference palette (dataviz):
# identity is fixed per run kind, never cycled
RUN_COLORS = {"train": "#2a78d6", "validation": "#eb6834"}
SURFACE = "#fcfcfb"
INK = "#0b0b0b"
INK_2 = "#52514e"
NON_METRIC = ("step", "time")


def load_runs(summary_dir: str) -> dict[str, list[dict]]:
    runs: dict[str, list[dict]] = {}
    for name in sorted(os.listdir(summary_dir)):
        if not name.endswith(".jsonl"):
            continue
        with open(os.path.join(summary_dir, name)) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        if rows:
            runs[name[:-len(".jsonl")]] = rows
    return runs


def write_csv(runs: dict[str, list[dict]], path: str) -> None:
    cols: list[str] = []
    for rows in runs.values():
        for r in rows:
            cols.extend(k for k in r if k not in cols)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["run"] + cols)
        for run, rows in runs.items():
            for r in rows:
                w.writerow([run] + [r.get(c, "") for c in cols])


def plot_runs(runs: dict[str, list[dict]], path: str) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    metrics: list[str] = []
    for rows in runs.values():
        for r in rows:
            metrics.extend(k for k in r
                           if k not in NON_METRIC and k not in metrics
                           and isinstance(r[k], (int, float)))
    if not metrics:
        raise SystemExit("no scalar metrics found")

    ncols = min(3, len(metrics))
    nrows = -(-len(metrics) // ncols)
    fig, axes = plt.subplots(nrows, ncols,
                             figsize=(4.6 * ncols, 3.2 * nrows),
                             squeeze=False)
    fig.patch.set_facecolor(SURFACE)
    for ax_idx, metric in enumerate(metrics):
        ax = axes[ax_idx // ncols][ax_idx % ncols]
        ax.set_facecolor(SURFACE)
        n_series = 0
        for run, rows in runs.items():
            pts = [(r["step"], r[metric]) for r in rows if metric in r]
            if not pts:
                continue
            xs, ys = zip(*sorted(pts))
            ax.plot(xs, ys, linewidth=2,
                    color=RUN_COLORS.get(run, INK_2), label=run,
                    marker="o" if len(xs) <= 20 else None, markersize=4)
            n_series += 1
        ax.set_title(metric, color=INK, fontsize=11)
        ax.tick_params(colors=INK_2, labelsize=8)
        ax.grid(True, color="#e8e7e3", linewidth=0.8)
        for spine in ax.spines.values():
            spine.set_color("#e8e7e3")
        ax.set_xlabel("step", color=INK_2, fontsize=9)
        if n_series >= 2 and ax_idx == 0:
            ax.legend(frameon=False, fontsize=9, labelcolor=INK)
    for ax_idx in range(len(metrics), nrows * ncols):
        axes[ax_idx // ncols][ax_idx % ncols].set_visible(False)
    fig.tight_layout()
    fig.savefig(path, dpi=120, facecolor=SURFACE)
    plt.close(fig)


def main(argv=None) -> str:
    """Writes ``<base>.csv`` and ``<base>.png``; returns ``<base>``."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--conf_file", help="derive summary dir from the config")
    p.add_argument("--summary_dir", help="directory of *.jsonl summaries")
    p.add_argument("--out", help="output basename (default <dir>/summary)")
    args = p.parse_args(argv)

    summary_dir = args.summary_dir
    if summary_dir is None:
        if not args.conf_file:
            p.error("need --summary_dir or --conf_file")
        from ..core.config import DMTConfig
        summary_dir = DMTConfig.from_ini(args.conf_file).summary_path
    runs = load_runs(summary_dir)
    if not runs:
        raise SystemExit(f"no *.jsonl summaries in {summary_dir}")
    base = args.out or os.path.join(summary_dir, "summary")
    write_csv(runs, base + ".csv")
    plot_runs(runs, base + ".png")
    print(f"wrote {base}.png and {base}.csv "
          f"({sum(len(r) for r in runs.values())} rows, {len(runs)} runs)")
    return base


if __name__ == "__main__":
    main()
