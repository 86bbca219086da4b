"""How many kernel launches of a torch.profiler window leave no device
record, with and without the port's armed ``device_profile`` and its
pads, in a fresh process and after a long profiled window.

Each window traces a region of launches of one small elementwise kernel,
either back to back (``burst``) or spaced on the host clock (``spaced``),
and its Chrome trace is read back with
``latentdiffeq_torch.utils.lost_kernel_records``: a launch is lost when
its launch record has no kernel record with the same correlation id. Three
ways of opening the window, interleaved:

- ``plain``: ``torch.profiler.profile`` entered right before the region;
- ``armed``: ``latentdiffeq_torch.utils.device_profile(pads=False)``,
  the warm-up step alone;
- ``device_profile``: ``device_profile()``, the warm-up step and the
  pads before and after the region (whose own lost launches are counted
  apart, ``pad_lost``).

``--poison N`` then runs one device-only ``device_profile`` window of N
launches (as ``chip_smoke.py``'s long training windows are) and the same
comparison again after it; ``--series R`` then R more rounds of a burst
and of a training step's 1,300 launches (``step``) under the three
openers. Each row has the skew of its kept kernel records against their
launches (``skew_us``: a few us where the device clock is mapped right)
and its time.
(``chip_smoke.py`` phase 4k makes the plain / ``device_profile``
comparison around a training step late in its process, where plain
windows lose launches.)

    python scripts/profiler_window.py [--reps 5] [--poison 600000]
        [--series 40 --keep DIR] [--out FILE.json]

Needs a card; prints one JSON object (and writes it to ``--out``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OPENERS = ("plain", "armed", "device_profile")
KEEP_FROM, KEEP_AT_MOST = 5, 6


def region(x, kind: str):
    if kind in ("burst", "step"):
        for _ in range(100 if kind == "burst" else 1300):
            x.add_(1.0)
    else:
        for _ in range(40):
            x.add_(1.0)
            t = time.perf_counter()
            while time.perf_counter() - t < 250e-6:
                pass
    torch.cuda.synchronize()


def skew_us(path: str) -> dict:
    """Kernel record start less its launch record's start (us), over the
    launches that kept their kernel record: min, median, max."""
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    launch = {e["args"].get("correlation"): e["ts"] for e in ev
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "Launch" in e.get("name", "")}
    d = sorted(e["ts"] - launch[c] for e in ev if e.get("cat") == "kernel"
               for c in [e.get("args", {}).get("correlation")]
               if c in launch)
    if not d:
        return {}
    return {"min": round(d[0], 1), "median": round(d[len(d) // 2], 1),
            "max": round(d[-1], 1)}


def window(how: str, kind: str, x, tmp: str, keep: str = None) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from latentdiffeq_torch.utils import device_profile, lost_kernel_records

    path = os.path.join(tmp, f"{how}_{kind}.json")
    opener = (profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) if how == "plain"
              else device_profile(pads=how == "device_profile"))
    with opener as prof:
        region(x, kind)
    prof.export_chrome_trace(path)
    out = {**lost_kernel_records(path), "skew_us": skew_us(path)}
    # keep the traces of the first KEEP_AT_MOST windows that lost KEEP_FROM
    # launches or more
    if (keep and out["lost"] >= KEEP_FROM and
            len(os.listdir(os.path.dirname(keep))
                if os.path.isdir(os.path.dirname(keep)) else ()) < KEEP_AT_MOST):
        os.makedirs(os.path.dirname(keep), exist_ok=True)
        os.replace(path, keep)
    return out


def poison(x, launches: int) -> float:
    """One device-only device_profile window of ``launches`` launches;
    its seconds."""
    from latentdiffeq_torch.utils import device_profile
    t0 = time.perf_counter()
    with device_profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        for i in range(launches):
            x.add_(1.0)
            if i % 10000 == 9999:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def compare(x, reps: int, tmp: str, phase: str, rows: list,
            openers=OPENERS, kinds=("burst", "spaced"), keep: str = None):
    t0 = time.perf_counter()
    for rep in range(reps):
        for kind in kinds:
            for how in openers:
                name = (os.path.join(keep, f"{len(rows)}_{how}_{kind}.json")
                        if keep else None)
                r = window(how, kind, x, tmp, keep=name)
                rows.append({"phase": phase, "rep": rep, "region": kind,
                             "open": how,
                             "at_s": round(time.perf_counter() - t0, 3),
                             **r})
                print(json.dumps(rows[-1]), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--poison", type=int, default=0,
                    help="launches of a long device-only window, after "
                         "which the comparison runs again (0: none)")
    ap.add_argument("--series", type=int, default=0,
                    help="then this many more rounds of burst and step "
                         "regions under the three openers (lossy traces "
                         "kept under --keep)")
    ap.add_argument("--keep", default=None,
                    help="directory for the traces of lossy --series "
                         "windows")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs a card")
    x = torch.zeros(1, device="cuda")
    region(x, "burst")
    rows, poison_s = [], None
    with tempfile.TemporaryDirectory() as tmp:
        compare(x, args.reps, tmp, "fresh", rows)
        if args.poison:
            poison_s = poison(x, args.poison)
            print(json.dumps({"poison_launches": args.poison,
                              "poison_s": poison_s}), flush=True)
            compare(x, args.reps, tmp, "after the long window", rows)
        if args.series:
            compare(x, args.series, tmp, "series", rows,
                    kinds=("burst", "step"), keep=args.keep)
    summary = {}
    for r in rows:
        s = summary.setdefault(f"{r['phase']}/{r['open']}/{r['region']}",
                               {"windows": 0, "lost": [], "lost_span_us": [],
                                "pad_lost": [], "launches": 0})
        s["windows"] += 1
        s["lost"].append(r["lost"])
        s["lost_span_us"].append(round(r["lost_span_us"], 1))
        s["pad_lost"].append(r["pad_lost"])
        s["launches"] = r["launches"]
    out = {"card": torch.cuda.get_device_name(0),
           "torch": torch.__version__, "poison_launches": args.poison,
           "poison_s": poison_s, "windows": summary}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"rows": rows, **out}, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
