"""Logging and scalar metrics: stdlib logging, JSONL, tensorboard / wandb /
comet where importable.

Port of ``svd_xtend_tpu/utils/logging.py``: the reference logs train_loss
and lr through accelerate's trackers (train_svd.py:837-838, 1057) and
stdlib logging (:614-626). The port runs one process, which writes:
``<logdir>/metrics.jsonl`` always (one record per write: step, ts and the
metrics), tensorboardX's event files for ``report_to`` tensorboard, and a
wandb or comet_ml run for those trackers, each only where its package
imports (``all`` takes the three).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict


def get_logger(name: str = "svd_xtend_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "%(asctime)s [%(levelname)s] p%(process)d %(name)s: %(message)s"))
        logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    return logger


class MetricWriter:
    """Scalar writer: JSONL always; the trackers of `report_to` that import."""

    def __init__(self, logdir: str, report_to: str = "tensorboard",
                 project: str = "SVDXtend"):
        self._tb = None
        self._wandb = None
        self._comet = None
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        if report_to in ("tensorboard", "all"):
            try:
                from tensorboardX import SummaryWriter
                self._tb = SummaryWriter(logdir)
            except ImportError:
                self._tb = None
        if report_to in ("wandb", "all"):
            try:
                import wandb
                self._wandb = wandb.init(project=project, dir=logdir)
            except Exception:
                self._wandb = None
        if report_to in ("comet_ml", "all"):
            try:
                import comet_ml
                self._comet = comet_ml.Experiment(project_name=project)
            except Exception:
                self._comet = None

    def write(self, step: int, metrics: Dict[str, float]):
        metrics = {k: float(v) for k, v in metrics.items()}
        self._jsonl.write(json.dumps({"step": int(step), "ts": time.time(),
                                      **metrics}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        if self._comet is not None:
            self._comet.log_metrics(metrics, step=step)

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
        if self._comet is not None:
            self._comet.end()
