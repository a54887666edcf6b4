"""Pluggable metric loggers.

Port of ``rho_diffusion_tpu/training/loggers.py``: each logger receives every
metrics record (a flat JSON-able dict). stdout (one line per record), jsonl
(appended to ``metrics.jsonl``, the machine-readable record), csv (the
header is the union of the keys seen; a new key rewrites the file once,
streaming it) and mlflow (numeric values as metrics, stepped by the
record's "step", strings as tags; it needs the ``mlflow`` package and
raises ImportError naming it where the package is absent).
"""
from __future__ import annotations

import csv
import json
import os
import tempfile
from pathlib import Path
from typing import Any, Protocol

from rho_diffusion_tpu_torch.registry import registry


class Logger(Protocol):
    def log(self, record: dict[str, Any]) -> None: ...

    def close(self) -> None: ...


@registry.register_logger("stdout")
class StdoutLogger:
    def log(self, record: dict[str, Any]) -> None:
        print(" ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in record.items()), flush=True)

    def close(self) -> None:
        pass


@registry.register_logger("jsonl")
class JSONLLogger:
    def __init__(self, path: str | Path = "metrics.jsonl") -> None:
        self.path = Path(path)
        self._f = None

    def log(self, record: dict[str, Any]) -> None:
        if self._f is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._f = open(self.path, "a")
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


@registry.register_logger("csv")
class CSVLogger:
    """Rows under a header that widens as records bring new keys; a resumed
    run adopts the header on disk and appends."""

    def __init__(self, path: str | Path = "metrics.csv") -> None:
        self.path = Path(path)
        self._fields: list[str] = []
        self._loaded = False

    def log(self, record: dict[str, Any]) -> None:
        if not self._loaded:
            self._loaded = True
            if self.path.exists():
                with open(self.path, newline="") as f:
                    self._fields = list(csv.DictReader(f).fieldnames or [])
        new_keys = [k for k in record if k not in self._fields]
        if new_keys:
            old_fields = list(self._fields)
            self._fields.extend(new_keys)
            self._rewiden(old_fields)
        with open(self.path, "a", newline="") as f:
            csv.DictWriter(f, fieldnames=self._fields, restval="").writerow(record)

    def _rewiden(self, old_fields: list[str]) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=str(self.path.parent), suffix=".csv.tmp")
        with os.fdopen(fd, "w", newline="") as out:
            w = csv.DictWriter(out, fieldnames=self._fields, restval="")
            w.writeheader()
            if old_fields and self.path.exists():
                with open(self.path, newline="") as f:
                    for row in csv.DictReader(f):
                        w.writerow({k: v for k, v in row.items() if v != ""})
        os.replace(tmp, self.path)

    def close(self) -> None:
        self._fields = []
        self._loaded = False


@registry.register_logger("mlflow")
class MLflowLogger:
    """MLflow tracker: numeric values become metrics, strings tags."""

    def __init__(self, experiment: str = "rho_diffusion_tpu", **kwargs) -> None:
        try:
            import mlflow
        except ImportError as e:
            raise ImportError(
                "MLflowLogger requires the 'mlflow' package (pip install mlflow), which is "
                "not installed.",
            ) from e
        self._mlflow = mlflow
        mlflow.set_experiment(experiment)
        self._run = mlflow.start_run(**kwargs)

    def log(self, record: dict[str, Any]) -> None:
        step = record.get("step")
        metrics = {k: float(v) for k, v in record.items()
                   if isinstance(v, (int, float)) and k != "step"}
        if metrics:
            self._mlflow.log_metrics(metrics, step=step)
        for k, v in record.items():
            if isinstance(v, str):
                self._mlflow.set_tag(k, v)

    def close(self) -> None:
        self._mlflow.end_run()


def build_loggers(specs, work_dir: str | Path) -> list:
    """Logger specs (names, {"name", "kwargs"} dicts, (name, kwargs) pairs or
    ready loggers) resolved through the registry; file loggers default into
    ``work_dir``."""
    work_dir = Path(work_dir)
    defaults = {"jsonl": {"path": work_dir / "metrics.jsonl"},
                "csv": {"path": work_dir / "metrics.csv"}}
    out = []
    for spec in specs:
        if hasattr(spec, "log"):
            out.append(spec)
            continue
        if isinstance(spec, str):
            name, kwargs = spec, {}
        elif isinstance(spec, dict):
            name, kwargs = spec["name"], spec.get("kwargs") or {}
        else:
            name, kwargs = spec
        out.append(registry.get("loggers", name)(**{**defaults.get(name, {}), **kwargs}))
    return out
