"""The manifest (``BENCHMARK.json``) and the data files it names.

Everything that belongs to one cell, configuration, traffic kind or
per-layer metric lives in a file of its own under ``perfbench/``, found by
the name the manifest gives it:

- ``configs/<config>.json``: the configuration as it is run (its ``kind``
  names the system module ``systems/<kind>.py``);
- ``workloads/<cell>.json``: the cell's traffic kind, its parameters, its
  trace slice and the limits of its correctness check;
- ``traffic/<kind>.py``: the module that runs a traffic kind;
- ``metrics/<metric>.py`` (or ``metrics/<stem>.py``, ``<stem>`` being the
  metric's name before its first dot): a per-layer metric's reader.

So a later cell, configuration or metric is new files plus new manifest
entries, and no edit of a file that is there.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
REPO = PKG.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    manifest: dict  # the whole BENCHMARK.json
    entry: dict  # the cell's entry in ``workloads``
    workload: dict  # workloads/<cell>.json
    config: dict  # configs/<config>.json
    data_root: Path  # where configs/ and workloads/ were read

    @property
    def params(self) -> dict:
        return self.workload["params"]

    def end_to_end(self) -> list[dict]:
        return [m for m in self.manifest["end_to_end"] if _reports(m, self.name)]

    def per_layer(self) -> list[dict]:
        return [m for m in self.manifest["per_layer"] if _reports(m, self.name)]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, manifest_path: Path | None = None,
              data_root: Path | None = None) -> Cell:
    """The cell ``name`` with its workload and configuration files, checked
    against the manifest's entry."""
    manifest = _read_json(manifest_path or REPO / "BENCHMARK.json")
    root = data_root or PKG
    entries = [w for w in manifest["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise SystemExit(f"no cell {name!r} in the manifest")
    entry = entries[0]
    workload = _read_json(root / "workloads" / f"{name}.json")
    config = _read_json(root / "configs" / f"{entry['config']}.json")
    for key in ("config", "chips"):
        if workload[key] != entry[key]:
            raise SystemExit(f"{name}: the workload file's {key} {workload[key]!r} "
                             f"differs from the manifest's {entry[key]!r}")
    return Cell(name, manifest, entry, workload, config, root)


def load_module(path: Path, tag: str):
    """Import a plug-in file (whose name may hold dots or dashes) as a
    module of its own."""
    mod_name = "perfbench_plugin_" + re.sub(r"\W", "_", tag)
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def traffic_module(cell: Cell):
    kind = cell.workload["traffic"]
    return load_module(PKG / "traffic" / f"{kind}.py", f"traffic_{kind}")


def system_module(config: dict):
    kind = config["kind"]
    return load_module(PKG / "systems" / f"{kind}.py", f"system_{kind}")


def metric_reader(name: str):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, else
    ``metrics/<stem>.py`` for the name's part before its first dot."""
    for stem in (name, name.split(".")[0]):
        path = PKG / "metrics" / f"{stem}.py"
        if path.exists():
            return load_module(path, f"metric_{stem}").read
    raise SystemExit(f"no reader for per-layer metric {name!r}")
