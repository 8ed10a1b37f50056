"""The port's five example scripts (`repro_torch.examples`) on the CPU.

One child process runs every example's `main` with `--device cpu` and
tiny arguments, then reports per example whether it returned, its numbers,
and whether `jax` or the JAX package (`repro`) ever entered `sys.modules`:
the examples are the port's way in for a reader and import neither.
"""
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "segmentation", "train_spiking_lm",
            "serve_spiking_lm", "long_context")

SCRIPT = textwrap.dedent("""
    import importlib, json, sys, traceback
    import torch
    torch.set_num_threads(2)
    ckpt = sys.argv[1]
    ARGS = {
        "quickstart": [],
        "segmentation": ["--steps", "3", "--batch", "2", "--img", "16"],
        "train_spiking_lm": ["--small", "--steps", "5", "--batch", "2",
                             "--seq", "16", "--ckpt-dir", ckpt],
        "serve_spiking_lm": ["--requests", "3", "--max-new", "3"],
        "long_context": ["--ctx", "2048", "--tokens", "3"],
    }

    def numbers(x):
        if isinstance(x, bool) or x is None or isinstance(x, str):
            return []
        if isinstance(x, (int, float)):
            return [float(x)]
        if isinstance(x, dict):
            return [n for v in x.values() for n in numbers(v)]
        if isinstance(x, (list, tuple)):
            return [n for v in x for n in numbers(v)]
        return []

    for name, args in ARGS.items():
        try:
            mod = importlib.import_module("repro_torch.examples." + name)
            out = mod.main(args + ["--device", "cpu"])
            rec = {"ok": True, "numbers": numbers(out), "out": {
                k: v for k, v in out.items() if not isinstance(v, list)}}
            if name == "serve_spiking_lm":
                rec["states"] = out["states"]
                rec["generated"] = [len(g) for g in out["spiking"] +
                                    out["dense"]]
        except BaseException:
            rec = {"ok": False, "error": traceback.format_exc()}
        mods = [m for m in sys.modules if m == "jax" or
                m.startswith("jax.") or m == "repro" or
                m.startswith("repro.")]
        rec["foreign_modules"] = mods
        print("EXAMPLE " + name + " " + json.dumps(rec), flush=True)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("examples") / "ckpt"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(ckpt)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    out = {}
    for line in proc.stdout.splitlines():
        if line.startswith("EXAMPLE "):
            _, name, rec = line.split(" ", 2)
            out[name] = json.loads(rec)
    assert set(out) == set(EXAMPLES), (proc.stdout[-3000:],
                                       proc.stderr[-3000:])
    return out


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu_without_jax(runs, name):
    rec = runs[name]
    assert rec["ok"], rec.get("error")
    assert rec["foreign_modules"] == []
    assert rec["numbers"] and all(math.isfinite(x) for x in rec["numbers"])
    if name == "segmentation":
        assert 0.0 <= rec["out"]["initial_iou"] <= 1.0
    if name == "train_spiking_lm":
        assert rec["out"]["last"] < rec["out"]["first"]
    if name == "serve_spiking_lm":
        assert set(rec["states"]) == {"done"}
        assert rec["generated"] == [3] * 6
    if name == "long_context":
        assert rec["out"]["finite"]
        assert rec["out"]["kv_bytes"] > 100 * rec["out"]["state_bytes"]
