"""Metric logging (reference ``src/utils/slurm_logger.py`` + wandb dual-logger
setup, ``main_pretrain.py:232-288,333-351``).

Counterpart of ``chadavit_tpu/utils/logging.py``: ``MetricLogger`` appends one
JSON dict per logged step to ``training_logs.txt`` (the SLURMLogger contract,
reference ``slurm_logger.py:106-110``), and ``replay_to_wandb`` replays the
file into wandb where wandb is installed.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, log_dir: str, name: str = "training_logs.txt",
                 stdout_every: int = 50):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, name)
        self.stdout_every = stdout_every
        self._n = 0

    def log(self, metrics: Dict, step: Optional[int] = None):
        rec = {k: (float(v) if hasattr(v, "item") or isinstance(v, (int, float)) else v)
               for k, v in metrics.items()}
        if step is not None:
            rec["step"] = int(step)
        rec["time"] = time.time()
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        self._n += 1
        if self.stdout_every and self._n % self.stdout_every == 0:
            short = {k: (round(v, 5) if isinstance(v, float) else v) for k, v in rec.items()
                     if k != "time"}
            print(short, flush=True)


def replay_to_wandb(log_file: str, project: str, name: str, entity: Optional[str] = None,
                    run_id: Optional[str] = None) -> bool:
    """Replay an offline log file into wandb line by line (reference
    ``log_offline_wandb.py:5``). Returns False when wandb is unavailable."""
    try:
        import wandb
    except ImportError:
        return False
    run = wandb.init(project=project, name=name, entity=entity, id=run_id, resume="allow")
    with open(log_file) as f:
        for line in f:
            rec = json.loads(line)
            step = rec.pop("step", None)
            rec.pop("time", None)
            run.log(rec, step=step)
    run.finish()
    return True
