"""Console entry points (pyproject [project.scripts]).

The benchmark script lives at the repo root (bench.py) because it is a
measurement harness, not library code; this wrapper locates it relative to
the installed package so `pip install -e .` exposes it as
`orbslam3-tpu-bench` (the L7 build-shell analog of the reference's Gradle
targets, app/build.gradle)."""
import os
import runpy
import sys


def _run(rel_path: str, name: str):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, rel_path)
    if not os.path.exists(path):
        raise SystemExit(
            f"{name} requires a source checkout ({rel_path} not found "
            f"next to the package; run from the repository)")
    sys.argv = [rel_path] + sys.argv[1:]
    runpy.run_path(path, run_name="__main__")


def bench_main():
    _run("bench.py", "orbslam3-tpu-bench")
