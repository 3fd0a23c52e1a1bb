"""Per-process resource monitor (the port's copy of the reference's
``tools/monitor.py``): CPU% and RSS of the processes whose command line
contains a name, sampled from ``/proc`` into one CSV log a process, and
the summary of the device-memory logs that
``runtime.tracing.start_memory_monitor`` writes inside a workload
(``timestamp,device,bytes_in_use,peak_bytes_in_use,bytes_limit``).

    python -m opticalflowcontainer_tpu_torch.tools.monitor name1 name2 --duration 60
    python -m opticalflowcontainer_tpu_torch.tools.monitor --summarize-accel accel_usage_*.log
"""
from __future__ import annotations

import argparse
import os
import time


def _find_pids(name: str) -> list[int]:
    pids = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\x00", b" ").decode(errors="replace")
            if name in cmd:
                pids.append(int(pid))
        except OSError:
            continue
    return pids


def _sample(pid: int) -> tuple[int, int]:
    """(CPU ticks, user + system; resident bytes) of ``pid``."""
    with open(f"/proc/{pid}/stat") as f:
        parts = f.read().split()
    utime, stime = int(parts[13]), int(parts[14])
    with open(f"/proc/{pid}/statm") as f:
        rss_pages = int(f.read().split()[1])
    return utime + stime, rss_pages * os.sysconf("SC_PAGE_SIZE")


def summarize_accel(paths: list[str]) -> list[dict]:
    """Per device: samples, mean bytes in use, peak and limit (MB) over the
    device-memory logs ``paths``.  Rows that do not parse are skipped."""
    per_device: dict[str, list[float]] = {}
    peaks: dict[str, float] = {}
    limits: dict[str, float] = {}
    for path in paths:
        with open(path) as f:
            next(f, None)  # header
            for line in f:
                parts = line.strip().split(",")
                if len(parts) != 5:
                    continue
                _, dev, in_use, peak, limit = parts
                try:
                    in_use_f, peak_f = float(in_use), float(peak)
                except ValueError:
                    continue
                per_device.setdefault(dev, []).append(in_use_f)
                peaks[dev] = max(peaks.get(dev, 0.0), peak_f)
                if limit not in ("None", ""):
                    try:
                        limits[dev] = float(limit)
                    except ValueError:
                        pass
    return [{
        "device": dev,
        "samples": len(vals),
        "mean_in_use_mb": sum(vals) / len(vals) / 1e6,
        "peak_mb": peaks.get(dev, 0.0) / 1e6,
        "limit_mb": limits.get(dev, 0.0) / 1e6 or None,
    } for dev, vals in per_device.items()]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", help="process name substrings to track")
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--summarize-accel", nargs="+", metavar="LOG",
                    help="summarize device-memory logs and exit")
    args = ap.parse_args(argv)

    if args.summarize_accel:
        for row in summarize_accel(args.summarize_accel):
            lim = f"/{row['limit_mb']:.0f}" if row["limit_mb"] else ""
            print(f"{row['device']}: mean {row['mean_in_use_mb']:.1f} MB, "
                  f"peak {row['peak_mb']:.1f}{lim} MB "
                  f"({row['samples']} samples)")
        return 0
    if not args.names:
        ap.error("names required unless --summarize-accel")

    hz = os.sysconf("SC_CLK_TCK")
    files = {}
    # keyed by (name, pid): a process matching two names is sampled once a
    # name a tick, each with its own previous sample
    last: dict[tuple[str, int], tuple[int, float]] = {}
    t_end = time.time() + args.duration
    while time.time() < t_end:
        for name in args.names:
            for pid in _find_pids(name):
                if pid == os.getpid():
                    continue
                try:
                    ticks, rss = _sample(pid)
                except OSError:
                    continue
                key = (name, pid)
                if key not in files:
                    os.makedirs(args.out_dir, exist_ok=True)
                    safe = "".join(c if c.isalnum() or c in "-._" else "_"
                                   for c in name)
                    path = os.path.join(args.out_dir, f"cpu_usage_{safe}_{pid}.log")
                    files[key] = open(path, "w")
                    files[key].write("timestamp,cpu_pct,rss_mb\n")
                now = time.time()
                cpu_pct = 0.0
                if key in last:
                    dt_ticks = ticks - last[key][0]
                    dt_wall = now - last[key][1]
                    if dt_ticks >= 0:  # a reused pid makes the delta meaningless
                        cpu_pct = 100.0 * dt_ticks / hz / max(dt_wall, 1e-6)
                last[key] = (ticks, now)
                files[key].write(f"{now:.3f},{cpu_pct:.1f},{rss / 1e6:.1f}\n")
                files[key].flush()
        time.sleep(args.interval)
    for f in files.values():
        f.close()
    print(f"monitored {len(files)} process(es)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
