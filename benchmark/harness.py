"""What every driver shares: a cell found by its name, the card, the
per-layer metric readers, the JAX check and the result line.

A cell `<name>` is the entry of BENCHMARK.json's workloads with that name
and the file benchmark/workloads/<name>.json (its configuration and
traffic mix by name, and the limits of the numbers its run compares); its
configuration is benchmark/configs/<config>.json, its traffic mix
benchmark/traffic/<traffic>.json, which names the driver
benchmark/drivers/<driver>.py; a per-layer metric `<metric>` is read by
benchmark/metrics/<metric>.py. Adding any of them edits no file here.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
REFUSED_MODULES = ("jax", "jaxlib", "flax", "tpudab")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """A module of the benchmark by its file (names hold dots)."""
    spec = importlib.util.spec_from_file_location(f"benchmark_{path.parent.name}_{path.stem}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]      # BENCHMARK.json's end-to-end metrics this cell reports
    per_layer: List[dict]       # and its per-layer metrics

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def load_cell(name: str, bench: Optional[dict] = None, withdrawn: bool = False) -> Cell:
    """The cell `name` from BENCHMARK.json and its files; with withdrawn=True
    also a cell taken out of it, from benchmark/withdrawn.json (for its
    tests and calibrate.py; benchmark.run never passes it)."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    if withdrawn:
        out = load_json(BENCH / "withdrawn.json")
        bench = {k: bench[k] + [e for e in out[k] if e["name"] not in {b["name"] for b in bench[k]}]
                 for k in ("workloads", "end_to_end", "per_layer")}
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    spec = load_json(BENCH / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if spec[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json names {key} {spec[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(name, entry["chips"], load_json(BENCH / "configs" / f"{entry['config']}.json"),
                load_json(BENCH / "traffic" / f"{entry['traffic']}.json"), spec["limits"],
                e2e, per_layer)


def driver_module(cell: Cell) -> ModuleType:
    return load_module(BENCH / "drivers" / f"{cell.driver}.py")


def read_per_layer(cell: Cell, readings: dict) -> Dict[str, dict]:
    """Each per-layer metric of the cell from its reader; a reader that
    finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        value = load_module(BENCH / "metrics" / f"{m['name']}.py").read(readings)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def card(chips: int) -> dict:
    """The card's name, count and power limit; exits without a result where
    torch sees no CUDA device or fewer than the cell asks for."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"error: the cell needs {chips} CUDA device(s), torch sees {n}", file=sys.stderr)
        raise SystemExit(2)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}


def power_limit() -> str:
    """nvidia-smi's name and power limit of the cards, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def refuse_jax() -> None:
    """Exits without a result where jax, jaxlib, flax or tpudab is loaded
    (top-level module names compared whole: tpudab_torch is not tpudab)."""
    found = sorted({m.split(".")[0] for m in sys.modules} & set(REFUSED_MODULES))
    if found:
        print(f"error: the run loaded {', '.join(found)}", file=sys.stderr)
        raise SystemExit(3)


def emit(result: dict, checks: Dict[str, tuple]) -> None:
    """The checks on stderr as its last lines, then the result line on
    stdout with the checks as its last key."""
    line = dict(result)
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    sys.stdout.flush()
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


def judge(checks: Dict[str, tuple]) -> bool:
    """Every number within its limit."""
    return all(v <= lim for v, lim in checks.values())
