"""Small stand-ins of the benchmark's cells, for runs on the CPU (or a
quick one on the card): the cells' own configuration and traffic files,
cut to sizes a test run holds."""

from __future__ import annotations

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _load(kind: str, name: str) -> dict:
    return json.loads((ROOT / "portbench" / kind / f"{name}.json").read_text())


def sweep():
    cfg, tr = _load("configs", "config5"), _load("traffic", "c5-sweep")
    cfg["fields_per_case"] = 16
    tr.update(distinct_sweeps=2, warmup_sweeps=1, traced_iterations=1)
    tr["reference"]["block"] = 32
    tr["reference"]["control_maxiter"] = 400
    return cfg, tr


def _config3_32():
    """Config 3's recipe on the preset's 32^2 stand-in (4^2 ROM refined 3
    times), whose unlabeled term runs in float32."""
    cfg = _load("configs", "config3")
    m = cfg["model"]
    m.update(grid=32, nx_rom=4, ny_rom=4, num_refines=3,
             unsup_compute_dtype="float32")
    m["decoder"]["blocks"] = [1, 2]
    m["encoder"]["blocks"] = [1, 2]
    cfg["data"].update(N_s=8, N_val=4, N_u=16, armortized_bs=4,
                       labeled_pool=12)
    cfg["trainer"]["N_monte_carlo_elbo"] = 2
    return cfg


def label():
    cfg, tr = _config3_32(), _load("traffic", "c3-label")
    tr.update(pool=12, distinct_pools=2, warmup_pools=1, traced_iterations=1,
              checked_pool_below=2)
    return cfg, tr


def train():
    cfg, tr = _config3_32(), _load("traffic", "c3-train")
    tr.update(traced_iterations=2)
    return cfg, tr


CELLS = {"c5-sweep": sweep, "c3-label": label, "c3-train": train}
ONE_CARD = sorted(CELLS)


def execute(cell: str, seed: int = 2 ** 33 + 5, *, trace=False,
            device="cpu", seconds=0.5):
    """(driver, context, result) of one small run of ``cell``."""
    from portbench import run

    cfg, tr = CELLS[cell]()
    bench = copy.deepcopy(BENCH)
    if cell not in {w["name"] for w in bench["workloads"]}:
        # a cell whose files are here before its entry (c3-train-dp4)
        bench["workloads"].append({"name": cell, "config": "config3",
                                   "traffic": cell, "chips": 4, "why": "-"})
    return run.execute(cell, seed, seconds, trace, device=device,
                       bench=bench, config=cfg, traffic=tr)


def train_dp():
    cfg, tr = train()
    tr.update(_load("traffic", "c3-train-dp4"), traced_iterations=2)
    return cfg, tr


CELLS["c3-train-dp4"] = train_dp
