"""Two-file logging (counterpart of svnet_tpu/train/logs.py): a
timestamped verbose log and a fixed-name epoch log whose first line is
the flag namespace and whose ``EPOCH ... | Test: ... | Train: ...`` lines
are greppable."""

from __future__ import annotations

import logging
import os
import time


def configure_logging(root: str, name: str, extent: str | None = None):
    os.makedirs(root, exist_ok=True)
    formatter = logging.Formatter("%(message)s")
    if extent is None:
        extent = time.strftime("%Y-%m-%d-%H-%M-%S")
        formatter = logging.Formatter("%(asctime)s - %(message)s")
    name = f"{name}-{extent}"
    logger = logging.getLogger(f"svnet_tpu_torch.{name}")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    path = os.path.abspath(os.path.join(root, f"{name}.txt"))
    if not any(getattr(h, "baseFilename", None) == path for h in logger.handlers):
        handler = logging.FileHandler(path)
        handler.setFormatter(formatter)
        logger.addHandler(handler)

    def log_string(msg: str):
        logger.info(msg)
        print(msg, flush=True)

    return log_string
