#!/usr/bin/env python3
"""Compare what two runs of `chip_smoke.py` computed, leaving out what
they timed.

    python3 tools/smoke_diff.py OLD.txt NEW.txt

Each file is the standard output of one run. The JSON lines of the
phases that check the models (outputs, launch counts, spike rates and
drift, gradient distances) are matched in order by phase, name, case,
model and batch; every field whose name is a time, a rate or a share of
one (`*_ms`, `*_s`, `seconds`, `span`, ...) is dropped, the `kernel`
lines and the per-phase timings are skipped, and whatever is left must
be equal.
Of the final `kernels` line, each kernel's launches and error are
compared. Prints one line per field that differs; exits 1 if any does.
"""
import json
import re
import sys

TIMED = re.compile(r"ms|seconds|_s$|per_s|span|enqueue|host|speedup|ratio",
                   re.I)
SKIPPED = ("kernel", "phase_time", "device", "build")


def lines(path: str) -> list:
    out = []
    for line in open(path, encoding="utf-8", errors="replace"):
        if line.startswith("{"):
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                pass
    return out


def untimed(value):
    if isinstance(value, dict):
        return {k: untimed(v) for k, v in value.items()
                if not TIMED.search(k)}
    if isinstance(value, list):
        return [untimed(v) for v in value]
    return value


def key(rec: dict) -> tuple:
    return tuple(rec.get(f) for f in ("phase", "name", "case", "model",
                                      "batch"))


def diff(old: list, new: list) -> list:
    found, pending = [], {}
    for rec in old:
        pending.setdefault(key(rec), []).append(rec)
    for rec in new:
        k = key(rec)
        if not pending.get(k):
            found.append(f"only in the new run: {k}")
            continue
        was = pending[k].pop(0)
        if "kernels" in rec:
            for a, b in zip(was["kernels"], rec["kernels"]):
                for f in ("name", "launches", "max_abs_err"):
                    if a[f] != b[f]:
                        found.append(f"kernels {a['name']} {f}: {a[f]} -> "
                                     f"{b[f]}")
            continue
        if k[0] in SKIPPED:
            continue
        a, b = untimed(was), untimed(rec)
        for f in sorted(set(a) | set(b)):
            if a.get(f) == b.get(f):
                continue
            if isinstance(a.get(f), dict) and isinstance(b.get(f), dict):
                for g in sorted(set(a[f]) | set(b[f])):
                    if a[f].get(g) != b[f].get(g):
                        found.append(f"{k} {f}.{g}: {a[f].get(g)} -> "
                                     f"{b[f].get(g)}")
            else:
                found.append(f"{k} {f}: {a.get(f)} -> {b.get(f)}")
    found += [f"only in the old run: {k}" for k, v in pending.items() if v]
    return found


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    found = diff(lines(argv[0]), lines(argv[1]))
    for line in found:
        print(line)
    print(f"{len(found)} field(s) differ")
    return 1 if found else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
