#!/usr/bin/env python3
"""Local BA's two hand kernels on slices B's and E's local BA problems:
what ``chip_smoke.py``'s ``ba`` phase does not print, and the way to hold
this tree's build of the kernels against another's.

``capture PATH`` runs chip_smoke's slice B under ``GraphCapture`` and
slice E (B's sequence through ``AsyncSlamManager``) under another, and
saves each one's ``GRAPH_CALL``-th local BA problem, padded as
``GraphedTwoPass`` pads it, with its calibration and solve settings.

``probe PATH`` runs this tree's kernels (``kernels.py`` builds ``csrc``
into this tree's ``build/``) on them and prints one line each,
``[probe] <what> <json>`` (with ``--out FILE`` also appended to FILE):

- ``bins``: each problem's bins (``_bins``): per set the bins, entries,
  non-empty bins, the longest and the median non-empty one; for the
  (pose, pose) set the longest diagonal and off-diagonal bin;
- ``digests``: ``chip_smoke.ba_digests`` of every output of both kernels
  in both modes on the fixtures (``BA_CASE_KFS``, Huber and L2) and on
  each problem, with one digest a case over its outputs' digests;
- ``timing``: ``chip_smoke.ba_timing`` on each problem.

Another build of the kernels is a copy of this tree holding that build's
two sources; each copy builds into its own ``build/``. The same
``digests`` line means the same bits; times in turns are the copies'
``timing`` lines, the copies run one after another in one call:

    python3 ba_probe.py capture build/ba_problems.pt
    mkdir -p build/other && git archive HEAD | tar -x -C build/other
    for f in ba_normal_eq ba_schur_step; do git show \\
      OTHER:ov2slam_torch/csrc/$f.cu > build/other/ov2slam_torch/csrc/$f.cu
    done
    P=$PWD/build/ba_problems.pt
    for t in build/other . . build/other; do
      (cd $t && python3 ba_probe.py probe $P --label $t); done

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys

import numpy as np


def emit(what, obj, out=None):
    line = f"[probe] {what} " + json.dumps(obj)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def _problem_of(cap, dev):
    import torch

    from ov2slam_torch.solvers import ba_invdepth as bi

    if "solve_packed" not in cap.inputs:
        return None
    (est, prob, rho, ray, valid), _ = cap.inputs["solve_packed"]
    kw = est._solve_kw()
    args = tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev)
                 for a in (prob.kf_poses, prob.kf_fixed, rho,
                           prob.lm_anchor, ray, prob.obs_kf, prob.obs_lm,
                           prob.obs_px, prob.obs_cam, valid))
    run = bi.GraphedTwoPass(args, est.params, kw["robust_th"],
                            kw["iters_robust"], kw["iters_l2"])
    run._load(args)
    return dict(args=[t.cpu() for t in run.inputs], kw=kw,
                params={k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                        for k, v in est.params._asdict().items()})


def capture(path):
    import torch

    import chip_smoke

    dev = torch.device("cuda")
    out = {}
    with chip_smoke.GraphCapture() as cap:
        _, seq_b = chip_smoke.run_slice("B", dev)
    out["B"] = _problem_of(cap, dev)
    with chip_smoke.GraphCapture() as cap:
        chip_smoke.run_async_slice("E", dev, seq=seq_b)
    out["E"] = _problem_of(cap, dev)
    torch.save({k: v for k, v in out.items() if v is not None}, path)
    emit("captured", {k: None if v is None else [list(t.shape)
                                                for t in v["args"]]
                      for k, v in out.items()})


def load_problems(path, dev):
    import torch

    from ov2slam_torch.solvers.ba import BAParams

    out = {}
    for name, p in torch.load(path, weights_only=False).items():
        prm = BAParams(**{k: (v.to(dev) if isinstance(v, torch.Tensor)
                              else v) for k, v in p["params"].items()})
        out[name] = (tuple(t.to(dev) for t in p["args"]), prm, p["kw"])
    return out


def bin_lengths(args, prm):
    import chip_smoke

    s, _ = chip_smoke.ba_state(args, prm)
    out = {}
    for k in ("pp", "pose", "lm", "lp"):
        b = s["bins"][k]
        n = b.lengths[:b.n].cpu().numpy()
        nz = n[n > 0]
        out[k] = dict(bins=int(b.n), entries=int(n.sum()),
                      non_empty=int(nz.size), longest=int(n.max()),
                      median=float(np.median(nz)) if nz.size else 0.0)
    Kw = int(s["T_cw"].shape[0])
    pp = s["bins"]["pp"].lengths[:Kw * Kw].cpu().numpy().reshape(Kw, Kw)
    out["pp"].update(longest_diagonal=int(pp.diagonal().max()),
                     longest_off_diagonal=int(
                         (pp * (1 - np.eye(Kw, dtype=pp.dtype))).max()))
    return out


def probe(path, label, out):
    import torch

    import chip_smoke

    dev = torch.device("cuda")
    emit("device", dict(smi=chip_smoke.nvidia_smi_line(), label=label,
                        torch=torch.__version__), out)
    probs = load_problems(path, dev)
    cases = []
    for n_kf in chip_smoke.BA_CASE_KFS:
        case, cprm = chip_smoke.ba_case(n_kf, dev)
        for th in (chip_smoke.BA_ROBUST_TH, 0.0):
            cases.append((f"fixture {n_kf} KFs {'huber' if th else 'l2'}",
                          case, cprm, th))
    for name, (args, prm, kw) in probs.items():
        emit("bins", dict(problem=name, label=label,
                          valid=int(args[9].sum()),
                          **bin_lengths(args, prm)), out)
        for th in (kw["robust_th"], 0.0):
            cases.append((f"slice {name} {'huber' if th else 'l2'}", args,
                          prm, th))
    digests = {c[0]: chip_smoke.ba_digests(*c[1:]) for c in cases}
    combined = {c: hashlib.sha1("".join(
        d[k] for k in chip_smoke.BA_DIGEST_OUTPUTS).encode()).hexdigest()[:12]
        for c, d in digests.items()}
    emit("digests", dict(label=label, combined=combined, digests=digests),
         out)
    for name, (args, prm, kw) in probs.items():
        t = chip_smoke.ba_timing(args, prm, kw["robust_th"])
        emit("timing", dict(problem=name, label=label, **{
            k: {f: v[f] for f in ("ms", "device_ms", "plain_ms", "bound_ms",
                                  "chain_ms", "kernels") if f in v}
            for k, v in t.items() if k != "shape"}), out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("capture")
    c.add_argument("path")
    p = sub.add_parser("probe")
    p.add_argument("path")
    p.add_argument("--label", default="")
    p.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("ba_probe: needs a CUDA device", file=sys.stderr)
        return 2
    if a.cmd == "capture":
        capture(a.path)
    else:
        probe(a.path, a.label, a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
