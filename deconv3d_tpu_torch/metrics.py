"""Observability: JSONL metrics stream + stdlib logging (SURVEY.md §5.5).

Reference parity: deconv3d logs progress percentages and saves chi²/
acceptance traces at the end; here every segment emits a structured JSONL
record (machine-readable) and a human log line, during the run.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Optional

logger = logging.getLogger("deconv3d_tpu_torch")


class MetricsWriter:
    """Append-only JSONL metrics file + mirrored log lines."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh = open(path, "a") if path else None
        self.t0 = time.time()

    def write(self, **record) -> dict:
        record.setdefault("t", round(time.time() - self.t0, 3))
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        logger.info(
            "sweep %s: chi2=%.6g acc=%.3f (%.1f sweeps/s)",
            record.get("sweep", "?"), record.get("chi2", float("nan")),
            record.get("acceptance", float("nan")),
            record.get("sweeps_per_sec", float("nan")),
        )
        return record

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
