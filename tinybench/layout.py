"""Where the benchmark finds each piece, by the name it is given.

  * a cell ``<cell>``:        ``workloads/<cell>.json`` (its configuration,
    its mix and the limits of its check);
  * a configuration:          ``configs/<config>.json``, whose ``family``
    names its graph generator, ``graphs/<family>.py``;
  * a traffic mix:            ``traffic/<mix>.json``, whose ``scenario``
    names ``scenarios/<scenario>.py``;
  * a per-layer metric:       ``metrics/<metric>.py``, a reader.

A later cell, configuration, mix or metric is a new file; nothing here
lists them.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _checked(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, label: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(label, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def names(kind: str, suffix: str, root: Optional[Path] = None) -> List[str]:
    d = (root or ROOT) / kind
    return sorted(p.name[:-len(suffix)] for p in d.iterdir()
                  if p.name.endswith(suffix) and not p.name.startswith("_"))


def cell(name: str, root: Optional[Path] = None) -> dict:
    return _json((root or ROOT) / "workloads" / f"{_checked(name)}.json")


def config(name: str, root: Optional[Path] = None) -> dict:
    return _json((root or ROOT) / "configs" / f"{_checked(name)}.json")


def traffic(name: str, root: Optional[Path] = None) -> dict:
    return _json((root or ROOT) / "traffic" / f"{_checked(name)}.json")


def graph_family(name: str, root: Optional[Path] = None) -> ModuleType:
    return _module((root or ROOT) / "graphs" / f"{_checked(name)}.py",
                   f"tinybench_graph_{name}")


def scenario(name: str, root: Optional[Path] = None) -> ModuleType:
    return _module((root or ROOT) / "scenarios" / f"{_checked(name)}.py",
                   f"tinybench_scenario_{name}")


def metric_readers(root: Optional[Path] = None) -> Dict[str, ModuleType]:
    """Every reader of ``metrics/``, by its metric's name."""
    d = (root or ROOT) / "metrics"
    return {n: _module(d / f"{n}.py", "tinybench_metric_" + n.replace(
        ".", "_")) for n in names("metrics", ".py", root)
        if n != "__init__"}


def resolve(cell_name: str, root: Optional[Path] = None) -> dict:
    """A cell with its configuration and its mix read in."""
    c = cell(cell_name, root)
    return {"name": cell_name, "cell": c, "config": config(c["config"], root),
            "traffic": traffic(c["traffic"], root)}

