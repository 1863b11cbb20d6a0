"""CLI face for the telemetry plane's gauge snapshot.

``python -m paddle_tpu_torch.observability``            → JSON to stdout
``python -m paddle_tpu_torch.observability --prom``     → Prometheus text
``python -m paddle_tpu_torch.observability --out PATH`` → atomic snapshot
file (tmp + rename) in the chosen format — the node-exporter
textfile-collector shape a scraper can pick up from a live host.

The snapshot is whatever this process's :class:`StatRegistry` holds;
run it inside a serving process (or point a scraper at an ``--out``
file such a process writes) for live numbers.
"""
from __future__ import annotations

import argparse
import sys


def render(fmt: str) -> str:
    """The snapshot in ``fmt`` ("json" | "prom"), importable so a test
    reads both forms without a subprocess."""
    from ..framework.monitor import stats_prom, stats_report
    if fmt == "prom":
        return stats_prom()
    import json
    return json.dumps(stats_report(), indent=2, sort_keys=True) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.observability",
        description=__doc__.splitlines()[0])
    ap.add_argument("--prom", action="store_true",
                    help="Prometheus text format instead of JSON")
    ap.add_argument("--out", default=None,
                    help="write atomically to this path instead of "
                         "stdout")
    a = ap.parse_args(argv)
    fmt = "prom" if a.prom else "json"
    if a.out:
        from ..framework.monitor import write_stats_snapshot
        print(write_stats_snapshot(a.out, fmt=fmt))
    else:
        sys.stdout.write(render(fmt))
    return 0


if __name__ == "__main__":
    sys.exit(main())
