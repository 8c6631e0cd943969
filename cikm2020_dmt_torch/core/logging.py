"""Result-file logging and step timing (the port's own copy of the JAX
package's ``core/logging.py``).

The reference appends plain-text result files (reference
run_dnn.py:28-33) and prints a metric line per logged step
(run_dnn.py:344-360); ``Throughput`` adds the step time and examples/s.
"""

from __future__ import annotations

import datetime
import json
import os
import sys
import time


def log_to_file(text: str, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write(text if text.endswith("\n") else text + "\n")


def timestamp() -> str:
    return datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")


def log_line(msg: str) -> None:
    sys.stdout.write(f"[{timestamp()}] {msg}\n")
    sys.stdout.flush()


class SummaryWriter:
    """Scalar summaries as JSON lines, one file per run (the reference's
    TensorBoard scalars, run_dnn.py:243-256,514-523)."""

    def __init__(self, summary_dir: str, run: str = "train"):
        os.makedirs(summary_dir, exist_ok=True)
        self.path = os.path.join(summary_dir, f"{run}.jsonl")

    def scalars(self, step: int, values: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": int(step), "time": timestamp(),
                                **{k: float(v) for k, v in values.items()}})
                    + "\n")


class Throughput:
    """Examples/s from an exponential moving average of the step time
    (host clock between ticks)."""

    def __init__(self, alpha: float = 0.05):
        self.alpha = alpha
        self.last: float | None = None
        self.step_time_ema: float | None = None

    def tick(self, batch_examples: int) -> tuple[float, float]:
        now = time.perf_counter()
        if self.last is None:
            self.last = now
            return 0.0, 0.0
        dt = now - self.last
        self.last = now
        if self.step_time_ema is None:
            self.step_time_ema = dt
        else:
            self.step_time_ema += self.alpha * (dt - self.step_time_ema)
        eps = batch_examples / self.step_time_ema if self.step_time_ema else 0.0
        return self.step_time_ema, eps
