"""A cell's files, found by name: its entry in ``BENCHMARK.json``, its
workload file ``benchmark/workloads/<cell>.json``, its configuration file
``benchmark/configs/<config>.json``, its model family
``benchmark/reference/<model>.py``, its traffic driver
``benchmark/traffic/<traffic>.py`` and each per-layer metric's reader
``benchmark/metrics/<metric>.py``. Adding a cell, a configuration, a driver
or a metric adds files; nothing here names one."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from pathlib import Path
from types import SimpleNamespace


class Cell:
    """Everything one run of one cell reads from the checkout at ``root``."""

    def __init__(self, root, name: str):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        entries = {w["name"]: w for w in self.bench["workloads"]}
        if name not in entries:
            raise SystemExit(f"no workload '{name}' in BENCHMARK.json (have: {', '.join(entries)})")
        self.name = name
        self.entry = entries[name]
        self.workload = self._json("workloads", name)
        if self.workload["config"] != self.entry["config"] or self.workload["traffic"] != self.entry["traffic"]:
            raise SystemExit(f"workloads/{name}.json disagrees with BENCHMARK.json on its config or traffic")
        self.config = self._json("configs", self.entry["config"])
        self.params = self.workload.get("params", {})

    def _json(self, kind, name):
        path = self.root / "benchmark" / kind / f"{name}.json"
        if not path.is_file():
            raise SystemExit(f"missing {path.relative_to(self.root)}")
        return json.loads(path.read_text())

    def _applies(self, metric) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def end_to_end(self):
        """The end-to-end metrics this cell reports (``BENCHMARK.json``)."""
        return [m for m in self.bench["end_to_end"] if self._applies(m)]

    def per_layer(self):
        """The per-layer metrics read in this cell's traced run: listed for
        it, or listed for no cells and moving one of its end-to-end metrics."""
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]

    def traffic(self):
        """The traffic driver's module."""
        return load_file(self.root / "benchmark" / "traffic" / f"{self.entry['traffic']}.py",
                         f"benchmark_traffic_{self.entry['traffic']}")

    def family(self):
        """The configuration's model family, ``benchmark/reference/<model>.py``
        (``reference/retina_unet.py`` says what one holds)."""
        model = self.config["model"]
        path = self.root / "benchmark" / "reference" / f"{model}.py"
        if not path.is_file():
            raise SystemExit(f"configuration '{self.config['name']}' names model '{model}', "
                             f"which has no family file benchmark/reference/{model}.py")
        return load_file(path, f"benchmark_family_{model}")

    def reader(self, metric: str):
        """The ``read(run)`` function of a per-layer metric."""
        return load_file(self.root / "benchmark" / "metrics" / f"{metric}.py",
                         "benchmark_metric_" + metric.replace(".", "_").replace("-", "_")).read


def load_file(path: Path, module_name: str):
    """Import the Python file ``path`` as ``module_name``."""
    if not path.is_file():
        raise SystemExit(f"missing {path}")
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_config(config: dict) -> SimpleNamespace:
    """The configuration as the reference reads it: the published keys and
    the run's settings, from the configuration file alone."""
    return SimpleNamespace(**config["published"], **config["run"])


def program_config(config: dict):
    """The measured program's own configuration object for this
    configuration (its experiment's ``configs`` class, built under the
    file's ``port_env``), with every published key and run setting of the
    file written over it, so that a change of the program's defaults does
    not move the yardstick."""
    saved = {k: os.environ.get(k) for k in config["port_env"]}
    os.environ.update(config["port_env"])
    try:
        cf = importlib.import_module(config["port_config"]).configs()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    for key, value in {**config["published"], **config["run"]}.items():
        setattr(cf, key, value)
    return cf
