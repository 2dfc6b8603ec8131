"""The port's bench matrix -> one machine-readable JSON artifact (the JAX
package's ``tools/bench_matrix.py``; ``tools/bench_matrix.sh`` gives the
items' order).

Runs each item as its own subprocess, ``python -m
deepsense6g_tii_tpu_torch.tools.<tool> ...``, one at a time (two processes
on one card would time each other), takes the last line of its standard
output that starts with ``{`` as its result, and writes the matrix after
every item.  An item that exits non-zero, times out or prints no JSON line
is recorded with its error and the tail of its standard error; the loop
goes on.  A partial rerun (``--only``) keeps the other items' entries.

    python -m deepsense6g_tii_tpu_torch.tools.bench_matrix [--only a,b]
        [--out BENCH_MATRIX_torch.json]

Items: ``gpt_serve`` and ``mamba_serve`` (bench_serve),
``engine_e2e_gpt`` and ``engine_e2e_mamba`` (bench_engine),
``convergence_gpt`` (convergence_smoke), ``profile_gpt`` and
``profile_mamba`` (profile_step).  Every child runs on the card, and
raises without it.  The JAX matrix's train-step items (``gpt``, ``mamba``,
``gpt_30to5``, ``gpt_flash_off``) wait for the port's bench (ROADMAP.md
Queue 1 item 1).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PACKAGE = "deepsense6g_tii_tpu_torch"


def tool(name, *args):
    """The interpreter's arguments that run tool ``name``."""
    return ["-m", f"{PACKAGE}.tools.{name}", *args]


# name -> (environment overrides, the interpreter's arguments, timeout s)
ITEMS = {
    "gpt_serve": ({}, tool("bench_serve", "--arch", "gpt"), 1800),
    "mamba_serve": ({}, tool("bench_serve", "--arch", "mamba"), 1800),
    # cache -> loader -> prefetch -> pinned copy -> step
    "engine_e2e_gpt": ({"DEEPSENSE_BENCH_ARCH": "gpt"},
                       tool("bench_engine"), 3600),
    "engine_e2e_mamba": ({"DEEPSENSE_BENCH_ARCH": "mamba"},
                         tool("bench_engine"), 3600),
    # the whole training path through the flash kernels converges
    "convergence_gpt": ({}, tool("convergence_smoke", "--arch", "gpt"),
                        1800),
    "profile_gpt": ({"DEEPSENSE_BENCH_ARCH": "gpt"}, tool("profile_step"),
                    1800),
    "profile_mamba": ({"DEEPSENSE_BENCH_ARCH": "mamba"},
                      tool("profile_step"), 1800),
}


def run_item(env_over, args, timeout) -> dict:
    """One item in its own process: its JSON line, or the error."""
    env = dict(os.environ)
    env.update(env_over)
    t0 = time.time()
    try:
        p = subprocess.run([sys.executable, *args], env=env, cwd=ROOT,
                           capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"error": f"timeout after {timeout}s"}
    line = next((ln for ln in reversed(p.stdout.strip().splitlines())
                 if ln.startswith("{")), None)
    if p.returncode != 0 or line is None:
        return {"error": f"rc={p.returncode}",
                "stderr_tail": p.stderr.strip().splitlines()[-5:]}
    try:
        out = json.loads(line)
    except json.JSONDecodeError:
        # a brace-prefixed progress line is not the result line
        return {"error": "last brace-prefixed stdout line is not JSON",
                "line": line[:200]}
    out["wall_s"] = round(time.time() - t0, 1)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="",
                    help="comma-separated subset of item names")
    ap.add_argument("--out",
                    default=os.path.join(ROOT, "BENCH_MATRIX_torch.json"))
    args = ap.parse_args(argv)
    names = ([n.strip() for n in args.only.split(",") if n.strip()]
             or list(ITEMS))
    unknown = [n for n in names if n not in ITEMS]
    if unknown:
        raise SystemExit(f"unknown items {unknown}: {list(ITEMS)}")

    matrix = {"generated_unix": int(time.time()), "items": {}}
    if os.path.exists(args.out):           # partial reruns keep old entries
        try:
            with open(args.out) as f:
                matrix["items"] = json.load(f).get("items", {})
        except (json.JSONDecodeError, OSError):
            pass
    for name in names:
        env_over, child, timeout = ITEMS[name]
        print(f"=== {name} ({' '.join(child)}) ===", flush=True)
        matrix["items"][name] = run_item(env_over, child, timeout)
        print(json.dumps(matrix["items"][name]), flush=True)
        with open(args.out, "w") as f:     # persist after every item
            json.dump(matrix, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
