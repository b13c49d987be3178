#!/usr/bin/env python3
"""Time the stencil kernels K1, K2 and K3 of this checkout against another
version of the port, in turns, on one NVIDIA card.

    python3 stencil_ab.py OLD_ROOT [--json PATH]

OLD_ROOT is the root of another checkout of this repository (for example
the parent commit unpacked with ``git archive``); its port is loaded under
another module name and builds its kernels into OLD_ROOT/build/.  At every
shape of ``chip_smoke.STENCIL_SHAPES`` (K1 and K2 on the main paths) and
of ``chip_smoke.K3_SHAPES`` (K3, halo-padded):

- both versions' outputs against the plain version, bit for bit;
- device time per apply by CUDA events, in turns old, new, new, old: L2
  flushed (``chip_smoke.cuda_time_ms``: a 256 MB buffer zeroed before
  each call, so the L2 holds dirty lines), L2 flushed clean (the buffer
  read instead) and L2 warm; and each version's share of the HBM byte
  bound, taken from its clean time (a warm apply may be served from the
  L2, which the bound does not describe).

Then the host cost of each wrapper: host-clock microseconds per call over
1,000 unsynchronised calls at the smallest shape (K3: padded (7, 7, 256)),
in turns.  Prints the
card's name and power limit, one line per measurement and a JSON object
(also written to PATH with ``--json``).  Imports torch, numpy, the standard
library and the two ports only.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import chip_smoke as cs

HOST_CALLS = 1000
FLUSHED_REPS, WARM_REPS = 100, 200


def load_other_port(root: Path):
    """The port under ``root`` as module ``gpipde_other`` (its ``ops``)."""
    pkg = root / "generative_physics_informed_pde_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "gpipde_other", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["gpipde_other"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("gpipde_other.ops")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old_root", type=Path)
    ap.add_argument("--json", type=Path)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("stencil_ab: needs a CUDA card", file=sys.stderr)
        return 2
    from generative_physics_informed_pde_tpu_torch import ops as new
    from generative_physics_informed_pde_tpu_torch.ops import stencil

    card = cs.card_line()
    cs.say(f"card: {card}")
    old = load_other_port(args.old_root.resolve())
    versions = {"old": old, "new": new}
    for name, mod in list(versions.items()):
        try:
            report = importlib.import_module(
                mod.__name__ + "._build").build_all()
        except RuntimeError as e:  # time the other version all the same
            cs.say(f"{name} kernels failed to build:\n{e}")
            del versions[name]
            continue
        for lib, r in report.items():
            cs.say(f"{name} {lib}: built in {r['seconds']:.2f} s")
            for line in r["log"].splitlines():
                if "registers" in line or "spill" in line:
                    cs.say(f"  ptxas: {line.strip()}")
    turns = [w for w in ("old", "new", "new", "old") if w in versions]

    sm = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    plain = {"apply_stencil": new.apply_stencil_reference,
             "apply_stencil_sym": new.apply_stencil_sym_reference,
             "apply_stencil_sym_blocked":
                 new.apply_stencil_sym_blocked_reference}
    k3 = "apply_stencil_sym_blocked"
    result = {"card": card, "sm_count": sm, "shapes": [], "host_us": {}}
    cases = [(name, *sh) for name, shapes in cs.STENCIL_SHAPES.items()
             for sh in shapes] + [(k3, *sh) for sh in cs.K3_SHAPES]
    for name, n, B, dtype in cases:
        fns = {w: getattr(m, name) for w, m in versions.items()}
        if name == k3:
            (coefs, v, mask), _ = cs.blocked_shape_inputs(n, B, dtype, gen)
            moved, bound, _ = cs.k3_cost(n, n, B, v.element_size())
        else:
            coefs, v, mask = cs.shape_inputs(name, n, B, dtype, gen)
            moved, bound, _ = cs.stencil_cost(name, n, n, B, v.element_size())
        ref = cs.bits(plain[name](coefs, v, mask))
        row = {"kernel": name, "shape": [n, n, B], "dtype": dtype,
               "bytes": moved, "bound_us": bound * 1e3,
               "plan": stencil.launch_plan(n, n, B, v.dtype, sm,
                                           name != "apply_stencil").as_ints()}
        for who, fn in fns.items():
            row[f"{who}_bit_equal"] = bool(torch.equal(
                cs.bits(fn(coefs, v, mask)), ref))
        times = {f"{w}_{m}": [] for w in fns
                 for m in ("flushed", "clean", "warm")}
        for mode, reps, fl in (("warm", WARM_REPS, None),
                               ("clean", FLUSHED_REPS, flush.sum),
                               ("flushed", FLUSHED_REPS, flush)):
            for who in turns:
                f = fns[who]
                times[f"{who}_{mode}"].append(1e3 * cs.cuda_time_ms(
                    lambda: f(coefs, v, mask), reps, fl))
        row.update(times)
        best = {k: min(t) for k, t in times.items()}
        row["share_of_bound"] = {
            w: bound * 1e3 / best[f"{w}_clean"] for w in fns}
        cs.say(f"{name} {(n, n, B)} {dtype}: bound {bound * 1e3:.2f} us;"
               f" best of 2 (us) {best}; turns {times}; share of the "
               f"bound (clean) {row['share_of_bound']}; bit-equal "
               f"{ {w: row[f'{w}_bit_equal'] for w in fns} }; plan "
               f"{row['plan']}")
        result["shapes"].append(row)
        del coefs, v, mask, ref

    # host cost of one call of each wrapper, device far from busy
    for name in (*cs.STENCIL_SHAPES, k3):
        if name == k3:
            (coefs, v, mask), _ = cs.blocked_shape_inputs(7, 256, "float64",
                                                          gen)
        else:
            coefs, v, mask = cs.shape_inputs(name, 5, 256, "float64", gen)
        per = {w: [] for w in versions}
        for who in turns:
            fn = getattr(versions[who], name)
            for _ in range(20):
                fn(coefs, v, mask)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn(coefs, v, mask)
            per[who].append(1e6 * (time.perf_counter() - t0) / HOST_CALLS)
            torch.cuda.synchronize()
        result["host_us"][name] = per
        cs.say(f"{name} host us per call, {tuple(v.shape)} f64, {HOST_CALLS} "
               f"unsynchronised calls: {per}")
    cs.say(f"card: {card}")
    text = json.dumps(result)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(text)
    print(text, flush=True)
    bad = [r for r in result["shapes"] if not r.get("new_bit_equal")]
    return 1 if bad or "new" not in versions else 0


if __name__ == "__main__":
    sys.exit(main())
