"""One run of one benchmark cell on this machine's cards.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Set-up draws the weights and a pool of
input batches from ``--seed`` on the card, builds the program's training
step, runs its first steps (their readings decide ``correct``) and a few
more to warm up. The window then runs the step back to back for
``--seconds``. With ``--trace 1`` a few more steps run under
``torch.profiler`` for the per-layer metrics. Then the program's state is
freed and the plain reference repeats the checked steps. The last line of
standard output is the result, one JSON object; the last lines of standard
error are the compared numbers beside their limits.

A cell on several cards runs one process a card: this process is rank 0
and starts the others, joined over NCCL on a free localhost port.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "deep_visual_slam_tpu")
FAULTS = ("unchanged", "half_batch", "half_loss", "no_exchange")


def _cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its CUDA sources into ``build/kernels/`` itself)."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run",
                                description="one run of one benchmark cell")
    p.add_argument("--workload", required=True, help="the cell's name in BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    hidden = argparse.SUPPRESS
    p.add_argument("--rank", type=int, default=0, help=hidden)
    p.add_argument("--port", type=int, default=0, help=hidden)
    # The tests' CPU runs at small sizes, and the planted faults.
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help=hidden)
    p.add_argument("--size", default=None, help=hidden)  # BxHxW a rank
    p.add_argument("--fault", choices=FAULTS, default=None, help=hidden)
    p.add_argument("--root", default=str(ROOT), help=hidden)
    return p.parse_args(argv)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(argv, world: int, port: int):
    children = [subprocess.Popen(
        [sys.executable, "-m", "benchmark.run", *argv, "--rank", str(r), "--port", str(port)],
        cwd=ROOT, stdout=sys.stderr.fileno()) for r in range(1, world)]

    def watch():
        while True:
            codes = [c.poll() for c in children]
            if any(c not in (None, 0) for c in codes):
                print(f"a rank exited with {codes}; stopping", file=sys.stderr, flush=True)
                _stop(children)
                os._exit(1)
            if all(c == 0 for c in codes):
                return
            time.sleep(0.5)

    threading.Thread(target=watch, daemon=True).start()
    return children


def _stop(children) -> None:
    for c in children:
        if c.poll() is None:
            c.kill()
    for c in children:
        c.wait()


def _mark(cuda: bool):
    import torch

    if not cuda:
        return time.perf_counter()
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def _seconds_between(a, b) -> float:
    return b - a if isinstance(a, float) else a.elapsed_time(b) / 1e3


def _agree(done: bool, host) -> bool:
    """Whether any rank's window is over, agreed over the gloo group."""
    import torch
    import torch.distributed as dist

    if host is None:
        return done
    flag = torch.tensor([int(done)])
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=host)
    return bool(flag.item())


def run_window(driver, seconds: float, host, cuda: bool, device) -> dict:
    """Steps back to back until ``seconds`` have passed on the host clock,
    then one synchronise. Step intervals come from events recorded after
    each step, read once after the window."""
    import torch

    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    marks, dispatch, losses = [_mark(cuda)], [], []
    start = time.perf_counter()
    while True:
        entry = driver.next_entry()
        t = time.perf_counter()
        out = driver.step(entry)
        dispatch.append(time.perf_counter() - t)
        marks.append(_mark(cuda))
        losses.append(out["loss"].detach().float())
        if _agree(time.perf_counter() - start >= seconds, host):
            break
    if cuda:
        torch.cuda.synchronize(device)
    end = time.perf_counter()
    values = torch.stack(losses).cpu().tolist()
    return {
        "start": start, "seconds": end - start, "steps": len(dispatch),
        "dispatch_s": dispatch,
        "intervals_s": [_seconds_between(a, b) for a, b in zip(marks, marks[1:])],
        "failed": sum(1 for v in values if not math.isfinite(v)),
        "peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else 0,
    }


def traced_window(driver, steps: int, rank: int, out_dir: Path, cuda: bool, device) -> dict:
    """``steps`` more steps with the profiler recording the device, between
    synchronises; returns the device operations, the benchmark's host spans
    and the window on the trace's clock, and K1's launch counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import trace
    from deep_visual_slam_torch.ops.photometric_cuda import reprojection_loss as k1

    def now_us():
        return time.time_ns() / 1e3

    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    sync()
    fwd, bwd = k1.launches, k1.backward_launches
    spans = []
    with profile(activities=[ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]) as prof:
        start = now_us()
        for _ in range(steps):
            t = now_us()
            entry = driver.next_entry()
            u = now_us()
            driver.step(entry)
            v = now_us()
            spans += [("pick_batch", t, u - t), ("dispatch", u, v - u)]
        sync()
        end = now_us()
        spans.append(("readback", v, end - v))
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"trace.rank{rank}.json"
    prof.export_chrome_trace(str(path))
    return {"kernels": trace.read_chrome_trace(path), "spans": spans,
            "window_us": (start, end), "steps": steps,
            "k1_fwd": k1.launches - fwd, "k1_bwd": k1.backward_launches - bwd}


def run_rank(args, cell, rank: int, world: int, port: int):
    """Set-up, window, traced window and, on rank 0, the reference: returns
    rank 0's result, None on the other ranks."""
    import torch
    import torch.distributed as dist

    from benchmark import cells, yardsticks
    from deep_visual_slam_torch.parallel import init_distributed, make_mesh

    cuda = args.device == "cuda"
    device = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(device)
    elif world > 1:  # the tests' ranks share this machine's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mesh = host = None
    if world > 1:
        init_distributed(f"tcp://localhost:{port}", world_size=world, rank=rank,
                         local_rank=rank, device=device)
        mesh = make_mesh(device)
        host = dist.new_group(backend="gloo")
    traffic = cell.traffic
    if args.size:
        B, H, W = (int(x) for x in args.size.split("x"))
    else:
        B, H, W = traffic["batch_per_rank"], cell.config["height"], cell.config["width"]
    marks = [("joined", time.perf_counter())]
    driver = cells.driver(cell)(cell, args.seed, device, mesh, B, H, W, traffic["pool"],
                                args.fault)
    marks.append(("weights, inputs, step built", time.perf_counter()))
    program = driver.check_steps()
    marks.append(("checked steps", time.perf_counter()))
    for _ in range(traffic["warmup_steps"]):
        driver.step(driver.next_entry())
    flops = yardsticks.train_step_flops(cell.config, B * world, H, W)
    marks.append(("warm-up steps", time.perf_counter()))
    if rank == 0:
        phases, last = [], T0
        for name, t in marks:
            phases.append(f"{name} {t - last:.2f} s")
            last = t
        inside = ", ".join(f"{k} {v:.2f} s" for k, v in driver.setup_s.items())
        print("set-up: " + ", ".join(phases) + f" (of which {inside})", file=sys.stderr)
    if host is not None:
        dist.barrier(group=host)
    window = run_window(driver, args.seconds, host, cuda, device)
    setup_s = window["start"] - T0
    traced = None
    if args.trace:
        traced = traced_window(driver, traffic["trace_steps"], rank,
                               Path(args.root) / "benchmark" / "out", cuda, device)
    mine = {"window": window, "trace": traced}
    ranks = [mine]
    if host is not None:
        ranks = [None] * world if rank == 0 else None
        dist.gather_object(mine, ranks, dst=0, group=host)
    driver.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if rank != 0:
        dist.destroy_process_group()
        return None
    reference = driver.reference_reading()
    if world > 1:
        dist.destroy_process_group()
    card = torch.cuda.get_device_name(device) if cuda else "cpu"
    return SimpleNamespace(
        cell=cell, setup_s=setup_s, windows=[r["window"] for r in ranks],
        traces=[r["trace"] for r in ranks] if args.trace else None,
        samples_per_step=driver.samples_per_step, flops_per_step=flops,
        shape=(B, H, W), world=world, card=card, peaks=yardsticks.card_peaks(card),
        program=program, reference=reference)


def breakdown(run) -> dict:
    """The device's largest kernel groups (ungrouped kernels by name) and
    the longest idle gaps, labelled by the host span open over them, on
    rank 0, in seconds over the traced window."""
    from benchmark import trace, yardsticks

    summary = run.traces[0]
    ops = defaultdict(float)
    for name, _, dur in summary["kernels"]:
        ops[yardsticks.group_of(name) or name[:120]] += dur / 1e6
    gaps = sorted(trace.idle_gaps(summary), key=lambda g: -g[1])[:10]
    return {"device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda x: -x[1])[:10],
            "idle_gaps": [[label, us / 1e6] for label, us in gaps]}


def result(run, trace_on: bool):
    """The result line, and the lines of the compared numbers."""
    from benchmark import cells, check, trace

    metrics = {}
    for m in (run.cell.per_layer if trace_on else run.cell.end_to_end):
        value = cells.metric_reader(run.cell, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    found = check.numbers(run.program, run.reference)
    ok, lines = check.verdict(found, run.cell.limits)
    failed = max(w["failed"] for w in run.windows)
    device = {"platform": "gpu" if run.card != "cpu" else "cpu", "kind": run.card,
              "count": run.world,
              "memory_peak_bytes": max(w["peak_bytes"] for w in run.windows)}
    line = {"correct": ok and failed == 0, "attempted": run.windows[0]["steps"],
            "failed": failed, "metrics": metrics, "device": device}
    if trace_on:
        device["busy_s"] = statistics.mean(trace.busy_us(t) for t in run.traces) / 1e6
        lo, hi = run.traces[0]["window_us"]
        device["window_s"] = (hi - lo) / 1e6
        line["breakdown"] = breakdown(run)
    line["check"] = check.summary(found, run.cell.limits)
    return line, lines


def _plain(x):
    """JSON-safe: a number that is not finite is written as its name."""
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    root = Path(args.root)
    _cache_dirs(root)
    from benchmark import cells

    cell = cells.load(args.workload, root)
    import torch

    if args.device == "cuda":
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < cell.chips:
            print(f"{cell.name} needs {cell.chips} CUDA device(s); this machine has {found}",
                  file=sys.stderr)
            return 2
    world = cell.world
    children, port = [], args.port
    if world > 1 and args.rank == 0:
        port = _free_port()
        children = _spawn(argv, world, port)
    try:
        run = run_rank(args, cell, args.rank, world, port)
    except BaseException:
        _stop(children)
        raise
    if run is None:
        return 0
    for c in children:
        c.wait()
    line, lines = result(run, bool(args.trace))
    loaded = forbidden_modules()
    if loaded:
        print(f"the run loaded {', '.join(loaded)}; no result", file=sys.stderr)
        return 3
    for text in lines:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_plain(line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
