"""The four-rank training cell's driver on the CPU: four gloo processes,
rank 0 checks the sharded steps against the one-process reference; with
the exchange between the ranks left out the run is not correct."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
WORLD = 4


def _run_ranks(tmp_path, fault: str = "none"):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = tmp_path / "rank0.json"
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE=str(WORLD), LOCAL_WORLD_SIZE=str(WORLD),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--child", str(out), fault],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, logs):
        assert p.returncode == 0, err[-3000:]
    return json.loads(out.read_text())


def test_four_ranks_match_the_reference(tmp_path):
    got = _run_ranks(tmp_path)
    assert got["correct"], got["checks"]
    assert got["attempted"] >= 1


def test_exchange_left_out_is_not_correct(tmp_path):
    got = _run_ranks(tmp_path, "no_exchange")
    assert not got["correct"], got["checks"]


def _child(out: str, fault: str):
    import torch

    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    from portbench.tests import tiny

    if fault == "no_exchange":
        from generative_physics_informed_pde_tpu_torch.training import trainer

        trainer.Trainer._reduce_grads = lambda self: None
    _, ctx, res = tiny.execute("c3-train-dp4", seconds=1.0)
    if ctx.rank == 0:
        Path(out).write_text(json.dumps(res))


if __name__ == "__main__" and sys.argv[1:2] == ["--child"]:
    _child(sys.argv[2], sys.argv[3])
