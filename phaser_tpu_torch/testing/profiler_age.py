"""Whether a torch.profiler window comes back whole as the process ages: the
probe behind chip_smoke.py running phase 9 in a process of its own.

    python -m phaser_tpu_torch.testing.profiler_age [--ages 0,150,300]
        [--rapid 30]

At each age (seconds since the probe's first window) it profiles 20 calls of
ten distinct elementwise kernels as utils/trace.profile_window does (a
traced warm-up step of the same calls, then the active step), once without
idle time around each step and once with 0.2 s, and prints the active
step's device records against its kernel launches, and how far the first
and last device records start after their launches (the host-clock
offsets, in microseconds).  Then it profiles `--rapid` windows back to back
and counts those short of records.  Prints one JSON line last.  Needs a
CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import time


def _window(pad: float, iters: int = 20):
    """(device records, launches, first offset us, last offset us) of one
    window's active step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    x = torch.ones(1 << 16, device="cuda")
    ops = [lambda: x.add_(1), lambda: x.mul_(1), lambda: x.sub_(1),
           lambda: x.div_(1), lambda: x.clamp_(min=0), lambda: x.abs_(),
           lambda: x.neg_(), lambda: x.sqrt_(), lambda: x.square_(),
           lambda: x.fill_(1)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            time.sleep(pad)
            for i in range(iters):
                ops[i % len(ops)]()
            torch.cuda.synchronize()
            time.sleep(pad)
            prof.step()
    events = prof.events()
    launches = sorted(e.time_range.start for e in events
                      if e.device_type != DeviceType.CUDA and
                      e.name.startswith(("cudaLaunchKernel",
                                         "cudaMemsetAsync")))
    kernels = sorted(e.time_range.start for e in events
                     if e.device_type == DeviceType.CUDA and
                     not e.name.startswith("ProfilerStep"))
    if not kernels or not launches:
        return len(kernels), len(launches), None, None
    return (len(kernels), len(launches), kernels[0] - launches[0],
            kernels[-1] - launches[-1])


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--ages", default="0,150,300")
    ap.add_argument("--rapid", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    t0 = time.perf_counter()
    rows = []
    for age in (float(a) for a in args.ages.split(",")):
        time.sleep(max(0.0, age - (time.perf_counter() - t0)))
        for pad in (0.0, 0.2):
            dev, launches, first, last = _window(pad)
            rows.append({"age_s": time.perf_counter() - t0, "pad_s": pad,
                         "device_records": dev, "launches": launches,
                         "first_offset_us": first, "last_offset_us": last})
            print("age %.0f s, pad %.1f s: %d device records of %d launches; "
                  "first record %s us after its launch, last %s us"
                  % (rows[-1]["age_s"], pad, dev, launches, first, last),
                  flush=True)
    short = 0
    for _ in range(args.rapid):
        dev, launches, _, _ = _window(0.0)
        short += dev != launches
    age = time.perf_counter() - t0
    print("%d of %d back-to-back windows short of records at %.0f s"
          % (short, args.rapid, age), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "windows": rows, "rapid": args.rapid,
                      "rapid_short": short, "rapid_age_s": age}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
