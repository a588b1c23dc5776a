"""The readings that the limits of a cell are set from. Not run by the
benchmark's own runs.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 3 \
        --sides program control half_loss --dump <file.jsonl>

For each seed, in one process on one card, the cell's checked steps at its
own sizes from the seed's weights and inputs, and the plain reference's.
Each side is read against the reference: ``program`` runs the program as a
run does; ``control`` puts the reference in the program's place, computed
one precision below the configuration's bf16: every network tensor rounded
to fp8 e4m3 and its gradient to e5m2 (``nets.FP8``); ``half_batch``,
``half_loss`` and ``unchanged`` plant those faults under the program's
step (``training.TrainDriver``). Each seed prints one JSON line of the
compared numbers a side; ``--dump`` keeps every side's full reading (each
step's loss, each leaf's norms) for a look at other numbers. A cell on
several cards runs its program side through ``benchmark.run`` instead: its
reference and control need one card.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SIDES = ("program", "control", "half_batch", "half_loss", "unchanged")


def readings(cell, seed: int, sides, device, size=None):
    """``{side: reading}`` for ``seed``, with the reference's under
    ``"reference"``."""
    import torch

    from benchmark import cells
    from benchmark.reference import nets

    B, H, W = size or (cell.traffic["batch_per_rank"] * cell.world, cell.config["height"],
                       cell.config["width"])
    out = {}
    driver = None
    for side in sides:
        if side == "control":
            continue
        fault = side if side != "program" else None
        driver = cells.driver(cell)(cell, seed, device, None, B, H, W, 3, fault)
        out[side] = driver.check_steps()
        driver.free()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if driver is None:
        driver = cells.driver(cell)(cell, seed, device, None, B, H, W, 3)
        driver.free()
    out["reference"] = driver.reference_reading()
    if "control" in sides:
        out["control"] = driver.reference_reading(precision=nets.FP8())
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--sides", choices=SIDES, nargs="+", default=["program", "control"])
    p.add_argument("--dump", default=None, help="a JSON-lines file for the full readings")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=JSON",
                   help="configuration entries changed for a look (loss.auto_mask=false)")
    args = p.parse_args(argv)
    from benchmark import cells, check, run

    run._cache_dirs(ROOT)
    import torch

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    dump = open(args.dump, "a") if args.dump else None
    for seed in args.seeds:
        cell = cells.load(args.workload, ROOT)
        for item in args.set:
            key, value = item.split("=", 1)
            *path, last = key.split(".")
            node = cell.config
            for part in path:
                node = node[part]
            node[last] = json.loads(value)
        start = time.perf_counter()
        got = readings(cell, seed, args.sides, device)
        numbers = {side: check.numbers(r, got["reference"]) for side, r in got.items()
                   if side != "reference"}
        print(json.dumps({"workload": cell.name, "seed": seed, "set": args.set,
                          "numbers": numbers,
                          "seconds": time.perf_counter() - start,
                          "card": torch.cuda.get_device_name(device)}), flush=True)
        if dump:
            plain = {side: {**{k: v for k, v in r.items() if k not in ("outputs", "ddisp")},
                            "ddisp": [None if d is None else d.tolist() for d in r["ddisp"]]}
                     for side, r in got.items()}
            dump.write(json.dumps({"workload": cell.name, "seed": seed, "set": args.set,
                                   "numbers": numbers, "readings": plain}) + "\n")
            dump.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
