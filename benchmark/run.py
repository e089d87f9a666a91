"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload carla_rig.fuse --seed 7 \\
        --seconds 20 --trace 0

from the root of a checkout. The cell's files are found by its name:
``benchmark/workloads/<cell>.json`` (its configuration, traffic and
limits), ``benchmark/configs/<config>.json``,
``benchmark/traffic/<kind>.py`` (the generator and driver), and for
``--trace 1`` ``benchmark/metrics/<metric>.py`` for each per-layer metric
that ``BENCHMARK.json`` lists for the cell. The last line of standard
output is the result (a JSON object); the numbers that decide ``correct``
end standard error, each beside its limit. The run needs as many CUDA
devices as the cell asks for and exits with code 1, printing no result,
without them, when the program cannot be imported, or when a forbidden
module (JAX, or the JAX package) is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402

from benchmark import common  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description="one run of a benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def assemble(bench: dict, name: str, trace: bool, out: dict) -> dict:
    """The metrics of the result line: the cell's end-to-end metrics, or
    with ``trace`` its per-layer metrics that a reader found."""
    metrics = {}
    for m in common.cell_metrics(bench, name, trace):
        if trace:
            value = common.metric_reader(m["name"])(out["obs"])
            if value is not None:
                metrics[m["name"]] = (value, m["unit"])
        elif m["name"] == "setup_s":
            metrics["setup_s"] = (out["setup_s"], "s")
        else:
            metrics[m["name"]] = (out["e2e"][m["name"]][0], m["unit"])
    return metrics


def execute(args, device: str) -> int:
    """The run on ``device`` once the chips are found (``"cpu"`` drives a
    run without them, at the sizes the caller's cell files give): prints
    the checks and the result line; 1 on a forbidden module."""
    bench = common.spec()
    cell = common.workload(args.workload)
    out = common.traffic(cell["traffic"]["kind"]).run(
        cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    found = sorted(set(common.forbidden_loaded() + out.get("forbidden", [])))
    if found:
        print(f"benchmark: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 1
    metrics = assemble(bench, args.workload, bool(args.trace), out)
    tr = out["trace"] if args.trace else None
    device_rec = (common.device_record(
        out["chips"], out["memory_peak"],
        tr["busy_s"] if tr else None, tr["window_s"] if tr else None)
        if device == "cuda" else dict(platform="cpu", count=out["chips"]))
    breakdown = (dict(device_ops=tr["device_ops"], idle_gaps=tr["idle_gaps"])
                 if tr else None)
    if device == "cuda":
        # every device number stands beside the card's power limit
        print(f"benchmark: card: {common.power_limit()}", file=sys.stderr)
    if out.get("setup_parts"):
        print(f"benchmark: set-up by part (s): {out['setup_parts']}",
              file=sys.stderr)
    checks = out["checks"]
    line = common.result_line(common.passes(checks), out["attempted"],
                              out["failed"], metrics, device_rec, checks,
                              breakdown)
    sys.stderr.write("\n".join(common.checks_text(checks)) + "\n")
    sys.stderr.flush()
    print(line, flush=True)
    return 0


def main(argv) -> int:
    args = parse(argv)
    common.set_environment()
    cell = common.workload(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: the cell needs {cell['chips']} CUDA device(s)",
              file=sys.stderr)
        return 1
    return execute(args, "cuda")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
