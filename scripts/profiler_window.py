"""How many kernel launches at the start of a torch.profiler window leave
no device record, in a fresh process, with and without the port's armed
``device_profile``.

Each window traces a region of launches of one small elementwise kernel,
either back to back (``burst``) or spaced on the host clock (``spaced``),
and its Chrome trace is read back with
``latentdiffeq_torch.utils.lost_kernel_records``: a launch is lost when
its launch record has no kernel record with the same correlation id. Two
ways of opening the window, interleaved:

- ``plain``: ``torch.profiler.profile`` entered right before the region;
- ``device_profile``: ``latentdiffeq_torch.utils.device_profile``.

(``chip_smoke.py`` phase 4k makes the same comparison around a training
step late in its process, where plain windows lose launches.)

    python scripts/profiler_window.py [--reps 5] [--out FILE.json]

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


def region(x, kind: str):
    if kind == "burst":
        for _ in range(100):
            x.add_(1.0)
    else:
        for _ in range(40):
            x.add_(1.0)
            t = time.perf_counter()
            while time.perf_counter() - t < 250e-6:
                pass
    torch.cuda.synchronize()


def window(how: str, kind: str, x, tmp: str) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from latentdiffeq_torch.utils import device_profile, lost_kernel_records

    path = os.path.join(tmp, f"{how}_{kind}.json")
    opener = (device_profile() if how == "device_profile" else
              profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]))
    with opener as prof:
        region(x, kind)
    prof.export_chrome_trace(path)
    return lost_kernel_records(path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs a card")
    x = torch.zeros(1, device="cuda")
    region(x, "burst")
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for rep in range(args.reps):
            for kind in ("burst", "spaced"):
                for how in ("plain", "device_profile"):
                    r = window(how, kind, x, tmp)
                    rows.append({"rep": rep, "region": kind, "open": how,
                                 **r})
                    print(json.dumps(rows[-1]), flush=True)
    summary = {}
    for r in rows:
        s = summary.setdefault(f"{r['open']}/{r['region']}",
                               {"windows": 0, "lost": [], "launches": 0})
        s["windows"] += 1
        s["lost"].append(r["lost"])
        s["launches"] = r["launches"]
    out = {"card": torch.cuda.get_device_name(0),
           "torch": torch.__version__, "windows": summary}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"rows": rows, **out}, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
