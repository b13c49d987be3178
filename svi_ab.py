#!/usr/bin/env python3
"""Time SVI steps of this checkout's port against another version's, in
turns, on one NVIDIA card.

    python3 svi_ab.py OTHER_ROOT [--pairs N] [--json PATH]

OTHER_ROOT is the root of another checkout of this repository (for example
the parent commit unpacked with ``git archive``).  Each turn is a child
process that imports one checkout's port and, for the highres32 recipe and
the 'highres' recipe of ``bench.py`` (128 labeled, 128 validation and 1024
unlabeled fields drawn from the FFT random field with seeds 0 and 1, batch
64, Adam 1e-2, no monitor points), builds the trainer, takes 10 steps and
times the next 100 by CUDA events.  N pairs of turns (default 3) run
other, this, then this, other, and so on.  Prints the card's name and
power limit, one line per turn and a JSON object (also written to PATH
with ``--json``).  Imports torch, numpy, the standard library and the
ports only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

RECIPES = {"highres32": (32, 0.15), "highres": (64, 0.04)}
STEPS = 100

CHILD = r"""
import json, sys
import torch
sys.path.insert(0, {root!r})
from generative_physics_informed_pde_tpu_torch import fem
from generative_physics_informed_pde_tpu_torch.data import DataLoader
from generative_physics_informed_pde_tpu_torch.training import (
    CreateTrainer, TrainerParameters)

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
out = {{}}
for ident, (n, corr) in {recipes!r}.items():
    rf = fem.GaussianRandomField.from_image(n, n, 0.4, 0.8, corr,
                                            method="fft")
    X, Xu = (rf.sample(torch.Generator().manual_seed(seed), count,
                       dtype=torch.float64, device="cuda").cpu().numpy()
             for seed, count in ((0, 256), (1, 1024)))
    p = TrainerParameters()
    p.identifier = ident
    p.trainer.update(lr_init=1e-2, N_monitor_interval=10 ** 9)
    p.scheduler = {{"milestones": [250, 1500], "factor": 0.1 ** 0.5}}
    p.data.update(N_u=1024, N_s=128, N_u_max=1024, N_s_max=128, N_val=128,
                  armortized_bs=64)
    dlu = DataLoader(Xu)
    dlu.lock_physics_assembly()
    tr = CreateTrainer(p, DataLoader(X), dlu, device="cuda")
    for _ in range(10):
        tr.step()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range({steps}):
        tr.step()
    e.record()
    torch.cuda.synchronize()
    out[ident] = 1e3 * {steps} / s.elapsed_time(e)
print("RESULT " + json.dumps(out), flush=True)
"""


def turn(root: Path) -> dict:
    code = CHILD.format(root=str(root), recipes=RECIPES, steps=STEPS)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=900, check=False)
    found = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    if r.returncode != 0 or not found:
        sys.stderr.write(r.stdout[-4000:] + r.stderr[-4000:])
        raise SystemExit(f"the turn in {root} failed")
    return json.loads(found[0][len("RESULT "):])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--json", type=Path)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    roots = {"other": args.other.resolve(),
             "this": Path(__file__).resolve().parent}
    runs = []
    order = [("other", "this"), ("this", "other")]
    for tag in [t for i in range(args.pairs) for t in order[i % 2]]:
        steps_per_s = turn(roots[tag])
        print(f"{tag}: {json.dumps(steps_per_s)} steps/s", flush=True)
        runs.append({"version": tag, "steps_per_s": steps_per_s})
    out = {"card": card, "steps": STEPS, "runs": runs}
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
