"""One run of one cell: set-up, a closed loop of requests for the window,
the check against the reference, the metrics, the result line.

The loop sends the next request when the previous one has returned its
result to the host. The window runs from its start to the end of the last
request begun before ``seconds`` had passed, so a rate takes all the work
and all the time of the window. After the window the memory peak is
read, and the program's state is freed before the reference runs.

Which results are checked: for each pool entry the window served, one of
its requests, drawn from the seed (a reservoir of one); of those, the
traffic file's ``check`` entries (all where it names none), drawn from the
seed. Each is judged against the reference's account of that entry; the
worst of each number over them is compared with its limit.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from slam_bench import program, spec, traffic
from slam_bench.trace import DeviceTrace


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    cell: spec.Cell
    setup_s: float
    window_s: float
    t0: float  # the window's start and end, host clock
    t1: float
    requests: list  # (pool entry, start, end) of each completed request
    work: float  # units of work completed (scans, solves)
    stages: dict  # the timer's totals and counts over the window
    trace: DeviceTrace | None
    accounts: dict  # pool entry → the reference's account of it
    pool: list

    @property
    def done(self) -> int:
        return len(self.requests)

    @property
    def latencies(self) -> list:
        return [e - s for _k, s, e in self.requests]

    def stage_ms_per_request(self, *names) -> float | None:
        if not self.done:
            return None
        return 1e3 * sum(self.stages["totals"].get(n, 0.0)
                         for n in names) / self.done


def device_info(device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


def host_clock() -> dict:
    """The host's state at one moment: the process's and this thread's CPU
    seconds, and the machine's CPU jiffies (all and stolen) from
    ``/proc/stat`` where there is one."""
    snap = {"wall": time.perf_counter(), "cpu": time.process_time(),
            "thread": time.thread_time(), "jiffies": None}
    try:
        with open("/proc/stat") as f:
            v = [int(x) for x in f.readline().split()[1:]]
        snap["jiffies"] = (sum(v[:8]), v[7] if len(v) > 7 else 0)
    except (OSError, ValueError):
        pass
    return snap


def host_load(a: dict, b: dict) -> dict:
    """What the host did between two ``host_clock`` snapshots: the shares
    of the wall that the process and its main thread spent on a CPU, the
    share of the machine's CPU time the hypervisor stole, the load
    average and the CPUs' mean clock (MHz) at the end."""
    wall = b["wall"] - a["wall"]
    out = {"process_cpu_share": (b["cpu"] - a["cpu"]) / wall,
           "thread_cpu_share": (b["thread"] - a["thread"]) / wall}
    if a["jiffies"] and b["jiffies"]:
        total = b["jiffies"][0] - a["jiffies"][0]
        out["steal_share"] = (b["jiffies"][1] - a["jiffies"][1]) / max(total, 1)
    try:
        with open("/proc/loadavg") as f:
            out["load_1m"] = float(f.read().split()[0])
        with open("/proc/cpuinfo") as f:
            mhz = [float(ln.split(":")[1]) for ln in f if ln.startswith("cpu MHz")]
        out["cpu_mhz"] = sum(mhz) / len(mhz) if mhz else None
    except (OSError, ValueError, IndexError):
        pass
    return out


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def judge_all(drv, kept: dict, control: bool = False,
              accounts: dict | None = None) -> tuple:
    """The reference's account of each kept pool entry (those already in
    ``accounts`` are taken from there), and the worst of each number over
    the program's outputs (with ``control``, over the control's, made
    from the same entries) judged against them."""
    accounts, worst = dict(accounts or {}), {}
    for k in sorted(kept):
        if k not in accounts:
            accounts[k] = drv.reference(k, kept[k])
        judged = kept[k]
        if control:
            judged = drv.as_output(drv.reference(k, kept[k], control=True))
        for name, v in drv.judge(k, judged, accounts[k]).items():
            worst[name] = max(worst.get(name, -np.inf), float(v))
    return accounts, worst


@dataclasses.dataclass
class Window:
    t0: float
    t1: float
    requests: list  # (pool entry, start, end) of each completed request
    work: float
    attempted: int
    failed: int
    kept: dict  # pool entry → one of its outputs, drawn from the seed


def serve_window(drv, traffic_params: dict, seed: int,
                 seconds: float) -> Window:
    """The closed loop: the next request as soon as the last has returned,
    until ``seconds`` have passed since the first began."""
    order = traffic.visit_order(traffic_params, seed)
    draw = traffic.rng_for(seed, 3)
    seen, kept, requests = {}, {}, []
    work, attempted, failed = 0.0, 0, 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        k = next(order)
        attempted += 1
        ts = time.perf_counter()
        try:
            out = drv.serve(k)
        except Exception:  # a request that fails is counted, the run goes on
            failed += 1
            if failed == 1:
                traceback.print_exc()
            continue
        requests.append((k, ts, time.perf_counter()))
        work += drv.work(k)
        seen[k] = seen.get(k, 0) + 1
        if draw.random() * seen[k] < 1.0:  # a reservoir of one
            kept[k] = out
    return Window(t0, time.perf_counter(), requests, work, attempted, failed,
                  kept)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, control: bool = False) -> dict:
    """The result line's dict. ``control`` puts the reference, in the
    precision below the configuration's, in the program's place for the
    check (the program's window runs as always)."""
    device = torch.device(device)
    request = spec.load_module(cell.dirs, "requests", cell.traffic["request"])
    drv = request.Driver(cell.config, cell.traffic, seed, device)
    drv.warm()
    sync(device)
    drv.timer.reset()
    program.reset_launches()
    setup_s = time.perf_counter() - t_start

    tr = None
    if trace and device.type == "cuda":
        tr = DeviceTrace(program.launches().keys())
        tr.start()
    gc.collect()
    gc.freeze()  # the set-up's objects leave the collector's generations
    h0 = host_clock()
    w = serve_window(drv, cell.traffic, seed, seconds)
    host = host_load(h0, host_clock())
    if tr is not None:
        tr.stop()
    dev_info = device_info(device, cell.chips)
    stages = {"totals": dict(drv.timer.totals),
              "counts": dict(drv.timer.counts)}
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    kept = w.kept
    n = int(cell.traffic.get("check", len(kept)))
    if len(kept) > n:  # a sample of the pool entries, drawn from the seed
        pick = traffic.rng_for(seed, 4).choice(sorted(kept), n, replace=False)
        kept = {int(k): kept[int(k)] for k in pick}
    accounts = {}
    if tr is not None:
        # the kernels' counts read every request of the window, so every
        # pool entry served gets the reference's account (iterations,
        # rounds), after the window and outside set-up
        accounts = {k: drv.reference(k, out) for k, out in w.kept.items()}
    accounts, worst = judge_all(drv, kept, control, accounts)
    checks = {name: {"value": worst.get(name, float("nan")), "limit": lim}
              for name, lim in cell.limits.items()}
    correct = (w.failed == 0 and bool(kept) and all(
        c["value"] <= c["limit"] for c in checks.values()))

    run = Run(cell, setup_s, w.t1 - w.t0, w.t0, w.t1, w.requests,
              w.work, stages, tr, accounts, drv.pool)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = spec.load_module(cell.dirs, "metrics", m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    line = {"correct": bool(correct), "attempted": w.attempted,
            "failed": w.failed, "metrics": metrics, "device": dev_info}
    if tr is not None:
        line["device"]["busy_s"] = tr.busy_s(w.t0, w.t1)
        line["device"]["window_s"] = w.t1 - w.t0
        line["breakdown"] = {
            "device_ops": tr.top_ops(w.t0, w.t1),
            "idle_gaps": tr.idle_gaps(w.t0, w.t1, drv.timer.spans)}
        write_trace(cell.name, seed, tr, w, drv.timer.spans)
    line["host"] = host
    line["checks"] = checks
    return line


def write_trace(name: str, seed: int, tr: DeviceTrace, w: Window,
                spans) -> None:
    """The traced window's device events, requests, host spans and launch
    counts, as JSON under the temporary directory (a few MB)."""
    base = os.path.join(tempfile.gettempdir(), f"slam_bench-{name}-{seed}")
    tr.dump(base + "-trace.json", w.t0, w.t1)
    with open(base + "-requests.json", "w") as f:
        json.dump({"requests": [[k, s - w.t0, e - s] for k, s, e in w.requests],
                   "spans": [[n, s - w.t0, e - s] for n, s, e in spans],
                   "launches": program.launches()}, f)


def print_result(line: dict) -> None:
    """The host's load over the window, then each number compared beside
    its limit as the last lines on standard error, then the result line
    as the last line on standard output."""
    print("host " + json.dumps(line.get("host", {})), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {line['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
