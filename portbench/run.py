#!/usr/bin/env python
"""Run one benchmark cell of the PyTorch port once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: ``BENCHMARK.json`` (at the root of
the checkout) names the cell's configuration, whose sizes are in
``portbench/configs/<config>.json``; its traffic is
``portbench/traffic/<cell>.json``, which names the driver
``portbench/drivers/<driver>.py`` that sets the program up, runs the
measured window and checks what it produced against the plain reference in
``portbench/reference/``; each per-layer metric is read by
``portbench/layer_metrics/<metric>.py``.  A new cell, configuration, mix or
metric is new files and entries, never an edit.

With ``--trace 0`` the result line carries the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, read after a short traced window
that follows the measured one.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: every
number compared with its limit); the same checks end standard error.  The
run exits non-zero, printing no result, without a card (or with fewer
than the cell asks for), without the program beside this folder, or when
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PROGRAM = "generative_physics_informed_pde_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "generative_physics_informed_pde_tpu")


def process_start_time() -> float:
    """Wall-clock time at which this process started (from /proc; the
    import of this module where that is not readable)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(names=None) -> list:
    """The top-level names of the loaded modules (or of ``names``) that,
    compared whole, are JAX's or the JAX package's."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that ``cell`` reports:
    those listing it under ``workloads``, or without that key, all cells
    (a per-layer metric: all cells that report the metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


class Context:
    """What a driver is given and hands back: the cell's configuration
    and traffic, the run's arguments, the device, and the readings
    (``counters``, ``trace``, ``checks``) that the harness turns into the
    result line."""

    def __init__(self, *, cell, config, traffic, seed, seconds, trace,
                 device, root=ROOT, started=None):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.trace = int(seed), float(seconds), \
            bool(trace)
        self.device = device
        # a cell on several cards runs one process a card (``launch``)
        self.rank = int(os.environ.get("RANK", 0))
        self.world = int(os.environ.get("WORLD_SIZE", 1))
        self.root = Path(root)
        self.started = time.time() if started is None else started
        self.window_started = None
        self.e2e = {}
        self.counters = {}
        self.traced = None
        self.checks = []
        self.attempted = 0
        self.failed = 0
        self.memory_peak_bytes = 0

    @property
    def on_card(self) -> bool:
        return str(self.device).startswith("cuda")

    def sync(self):
        if self.on_card:
            import torch

            torch.cuda.synchronize()

    def start_window(self):
        """End of set-up: everything the window uses is built and warm."""
        self.sync()
        if self.on_card:
            import torch

            self.memory_peak_bytes = max(self.memory_peak_bytes,
                                         torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
        self.window_started = time.time()

    def window_peak(self) -> int:
        """Peak allocated bytes since :meth:`start_window` (0 off a card);
        the run's peak is kept in ``memory_peak_bytes``."""
        if not self.on_card:
            return 0
        import torch

        peak = torch.cuda.max_memory_allocated()
        self.memory_peak_bytes = max(self.memory_peak_bytes, peak)
        return peak

    def profile(self, fn, iterations: int):
        """Trace ``fn`` (which runs ``iterations`` iterations of the
        cell's work) and keep the reading for the per-layer readers."""
        from portbench.measure import profile_window

        self.traced = dict(profile_window(fn, self.on_card),
                           iterations=iterations)

    def check(self, name: str, value: float, limit: float):
        """One number compared with its limit (``value <= limit``)."""
        self.checks.append((name, float(value), float(limit)))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            v == v and v <= lim for _, v, lim in self.checks)


def execute(cell: str, seed: int, seconds: float, trace: bool, *,
            device: str = "cuda", bench: dict | None = None,
            config: dict | None = None, traffic: dict | None = None,
            started: float | None = None):
    """Run ``cell`` once -> (its driver, its context, its result object).
    ``bench`` / ``config`` / ``traffic`` default to the files the names
    lead to; tests pass small ones and ``device="cpu"``."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    wl = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if wl is None:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = config or load_json(ROOT / cfg_entry["file"])
    traffic = traffic or load_json(HERE / "traffic" / f"{cell}.json")
    driver = load_module(HERE / "drivers" / f"{traffic['driver']}.py",
                         f"portbench_driver_{traffic['driver']}")
    ctx = Context(cell=cell, config=config, traffic=traffic, seed=seed,
                  seconds=seconds, trace=trace, device=device,
                  started=process_start_time() if started is None
                  else started)
    driver.run(ctx)
    found = forbidden_modules()
    if found:
        raise RuntimeError("modules of JAX or the JAX package were loaded: "
                           + ", ".join(found))
    if ctx.window_started is None:
        raise RuntimeError("the driver never started its window")

    metrics = {}
    if not trace:
        values = dict(ctx.e2e, setup_s=ctx.window_started - ctx.started)
        for m in cell_metrics(bench, cell, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, cell, "per_layer"):
            reader = load_module(HERE / "layer_metrics" / f"{m['name']}.py",
                                 "portbench_metric_" + m["name"].replace(
                                     ".", "_").replace("-", "_"))
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if ctx.on_card else "cpu",
           "kind": "cpu", "count": int(wl["chips"]),
           "memory_peak_bytes": int(ctx.memory_peak_bytes)}
    if ctx.on_card:
        import torch

        dev["kind"] = torch.cuda.get_device_name(0)
    out = {"correct": ctx.correct, "attempted": ctx.attempted,
           "failed": ctx.failed, "metrics": metrics, "device": dev}
    if trace and ctx.traced is not None:
        t = ctx.traced
        dev["busy_s"] = t["busy_s"]
        dev["window_s"] = t["window_s"]
        out["breakdown"] = {
            "device_ops": [[k[:160], s] for k, s, _ in t["kernels"][:10]],
            "idle_gaps": [[k[:160], s] for k, s in t["idle"][:10]]}
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in ctx.checks}
    return driver, ctx, out


def launch(world: int, argv) -> list:
    """Make this process rank 0 of ``world`` (one card each, nccl over
    NVLink, no shared-memory transport) and start ranks 1.. as copies of
    this command."""
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
               NCCL_SHM_DISABLE="1")
    os.environ.update(env, RANK="0", LOCAL_RANK="0")
    return [subprocess.Popen([sys.executable, str(HERE / "run.py"), *argv,
                              "--rank", str(r)],
                             env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                             stdout=subprocess.DEVNULL)
            for r in range(1, world)]


def stop(children, timeout: float = 120.0) -> list:
    """Wait for the ranks this process started; end any still running
    after ``timeout`` seconds.  Returns the ranks that failed."""
    import subprocess

    failed = []
    deadline = time.time() + timeout
    for r, p in enumerate(children, start=1):
        try:
            p.wait(max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        if p.returncode != 0:
            failed.append(r)
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # set by rank 0 on the ranks it starts (a cell on several cards)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    started = process_start_time()

    if not (ROOT / PROGRAM / "__init__.py").is_file():
        print(f"the program ({PROGRAM}) is not beside {HERE.name}/",
              file=sys.stderr)
        return 2
    # every build and kernel cache at a fixed path inside the checkout
    cache = ROOT / "build" / "portbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    sys.path.insert(0, str(ROOT))

    import torch

    bench = load_json(ROOT / "BENCHMARK.json")
    wl = next((w for w in bench["workloads"] if w["name"] == args.workload),
              None)
    if wl is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(wl["chips"]):
        print(f"{args.workload} needs {wl['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 3
    import importlib

    prog = importlib.import_module(PROGRAM)
    if Path(prog.__file__).resolve().parent != (ROOT / PROGRAM).resolve():
        print(f"{PROGRAM} was imported from {prog.__file__}, not from this "
              "checkout", file=sys.stderr)
        return 2
    chips = int(wl["chips"])
    children = launch(chips, argv if argv is not None else sys.argv[1:]) \
        if chips > 1 and args.rank == 0 else []
    try:
        _, _, out = execute(args.workload, args.seed, args.seconds,
                            bool(args.trace), bench=bench, started=started)
    except RuntimeError as e:
        print(f"run failed: {e}", file=sys.stderr)
        return 4
    finally:
        failed = stop(children)
    if args.rank != 0:
        return 0
    if failed:
        print(f"ranks {failed} failed", file=sys.stderr)
        return 5
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
