#!/usr/bin/env python3
"""Device times of the front end's image kernels at slice B's shapes, and
the cuDNN convolution that computes the same filters (GPU only).

Renders slice B's frame 40 (752x480, in uint8 as the front end uploads it)
and, for each call below, runs it ``--calls`` times under
``torch.profiler`` (CUDA activity only) and once more ``--calls`` times
queued behind a sleep between two CUDA events:

- ``clahe``: CLAHE at slice B's clip limit;
- ``pyramid``: ``build_pyramid`` of CLAHE's output, 4 levels;
- ``pyr_down``: one pyramid level, 752x480 -> 376x240;
- ``scharr``: ``scharr_gradients`` of the frame (both gradients);
- ``blur``: BRIEF's 9-tap blur (``gaussian_blur(img, 2.0, 4)``);
- ``undistort``: ``undistort_points`` on 512 pixels through EuRoC's cam0
  (radtan, 8 steps), and ``undistort 72`` at 72 steps;
- ``tail eager``: the tracking step's tail as the eager sequence it was
  before the tail kernel (``torch.where``, ``undistort_points``, both
  frames' ``(. - c) / f`` and the pair mask ``&``) on 512 rows of a packed
  state; and, on a tree that has the tail kernel, ``tail`` (the same
  through ``undistort_normalize``, one launch), ``tail 72`` (72 steps)
  and ``tail stereo`` (stereo mapping's call: reference rows only);
- ``conv2d <filter>``: the library yardstick, ``F.conv2d`` of the
  replicate-padded image with the outer product of the taps (TF32 off,
  as the port runs), at the pyramid level (stride 2), the blur, and
  Scharr's pair (two output channels); the pad (``F.pad``) is timed as a
  call of its own (``pad <filter>``), since the yardstick takes it as a
  second call.

Prints one JSON line: each call's device kernels (name, launches a call,
mean device µs), its summed device µs a call from the trace, its device
ms a call queued, its host ms a call (CUDA events around one call, the
median of ``--calls``), the hand kernels' wrapper launches a call, and the
sha1 of its outputs' bytes (equal digests across two trees mean equal
bits); for the yardstick, its largest difference to the kernel's output;
and the undistortion's dependent chain (``chains``: the queued device ms
at 72 steps less that at 8, over 64, times 8). Runs on
any tree of the port, so that two builds compare in one chip call: copy
the script into an unpacked earlier tree and run it there too, in turns.

    python3 image_probe.py --label change --calls 20
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys


def trace_call(fn, calls: int):
    """(rows by kernel name, device µs a call) of ``calls`` calls of ``fn``
    from a torch.profiler trace of CUDA activity. A kernel that a call
    launches k > 1 times (a pyramid level a launch) also gets its mean µs
    by position in the call (``by_position``), where the trace holds k
    events for every call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.device_type != torch.autograd.DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        rows.setdefault(e.name, []).append(e.time_range.elapsed_us())
    out = {}
    for k, ts in sorted(rows.items(), key=lambda kv: -sum(kv[1])):
        row = dict(per_call=len(ts) / calls, mean_us=sum(ts) / len(ts))
        per = len(ts) // calls
        if per > 1 and per * calls == len(ts):
            row["by_position"] = [sum(ts[i::per]) / calls
                                  for i in range(per)]
        out[k[:90]] = row
    return out, sum(sum(ts) for ts in rows.values()) / calls


def wrapper_launches(fn):
    """The image and camera wrappers' launches one call of ``fn`` makes."""
    from ov2slam_torch.core import camera, image

    fns = [getattr(image, n, None) for n in (
        "separable_filter", "build_pyramid", "scharr_gradients", "clahe")]
    fns += [getattr(camera, n, None) for n in ("undistort_points",
                                               "undistort_normalize")]
    fns = [f for f in fns if hasattr(f, "launches")]
    n0 = [f.launches for f in fns]
    fn()
    return {f.__name__: f.launches - n for f, n in zip(fns, n0)
            if f.launches != n}


# EuRoC's cam0 (radtan): (fx, fy, cx, cy), coefficients
CAM0 = ((458.654, 457.296, 367.215, 248.375),
        (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05))
TAIL_ROWS = 512


def tail_calls(dev):
    """{name: call} of the undistortion and the tracking step's tail on
    ``TAIL_ROWS`` rows: the tracked pixels, and a packed (N+2, 8) state
    whose columns 0:2 (the slots' pixels) and 5:7 (the reference
    keyframe's undistorted pixels) are read as column views, as a frame
    gives them; the tail through the kernel only where the tree has it."""
    import numpy as np
    import torch

    from ov2slam_torch.core import camera as cm

    n = TAIL_ROWS
    rng = np.random.default_rng(1)
    state = rng.normal(size=(n + 2, 8)).astype(np.float32)
    state[:n, 0:2] = rng.uniform((-20.0, -20.0), (772.0, 500.0), (n, 2))
    state[:n, 5:7] = rng.uniform((-20.0, -20.0), (772.0, 500.0), (n, 2))
    rows = torch.as_tensor((state[:n, 0:2] + rng.uniform(
        -3.0, 3.0, (n, 2))).astype(np.float32), device=dev)
    st = torch.as_tensor(state, device=dev)
    px, ref = st[:n, 0:2], st[:n, 5:7]
    status = torch.as_tensor(rng.random(n) < 0.7, device=dev)
    ref_valid = torch.as_tensor(rng.random(n) < 0.7, device=dev)
    k, d = CAM0
    c = (*(torch.tensor(v, dtype=torch.float32, device=dev) for v in k),
         torch.tensor(d, dtype=torch.float32, device=dev))
    f, cc = torch.stack(c[0:2]), torch.stack(c[2:4])

    def eager():
        tracked = torch.where(status[:, None], rows, px)
        und = cm.undistort_points(tracked, *c)
        return [tracked, und, (und - cc) / f, (ref - cc) / f,
                status & ref_valid]

    calls = {"undistort": lambda: cm.undistort_points(px, *c),
             "undistort 72": lambda: cm.undistort_points(px, *c, iters=72),
             "tail eager": eager}
    if hasattr(cm, "undistort_normalize"):
        def tail(iters=8, stereo=False):
            def run():
                if stereo:
                    out = cm.undistort_normalize(rows, *c, False, iters,
                                                 ref=px)
                else:
                    out = cm.undistort_normalize(
                        rows, *c, False, iters, px=px, status=status,
                        ref=ref, ref_valid=ref_valid)
                return [t for t in out if t is not None]
            return run

        calls.update({"tail": tail(), "tail 72": tail(72),
                      "tail stereo": tail(stereo=True)})
    return calls


def digest(out):
    import torch

    h = hashlib.sha1()
    for t in (out if isinstance(out, (list, tuple)) else [out]):
        torch.cuda.synchronize()
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--only", nargs="+", default=None,
                    help="time only these calls (names as printed)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("image_probe: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from ov2slam_torch import kernels
    from ov2slam_torch.core import image as im
    from ov2slam_torch.io import synthetic
    from ov2slam_torch.models.frontend import to_u8
    from ov2slam_torch.roofline import nvidia_smi_line
    from ov2slam_torch.utils import profiles

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernels.build_all(["separable_filter", "clahe", "undistort_points"])
    seq = synthetic.stream_sequence(**chip_smoke.slice_configs()["B"][0],
                                    realism=None)
    clip = chip_smoke.slice_config("B", seq, profiles).clahe_val
    frame = seq.frame(chip_smoke.IMAGE_FRAME)[0]
    img = torch.as_tensor(to_u8(frame), device=dev).to(torch.float32)
    eq = im.clahe(img, clip)
    pyr = torch.as_tensor(np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32)
                          / 16.0, device=dev)
    g = torch.as_tensor(im.gaussian_kernel1d(2.0, 4), device=dev)
    smooth = torch.tensor([3.0 / 16.0, 10.0 / 16.0, 3.0 / 16.0],
                          device=dev)
    diff = torch.tensor([-0.5, 0.0, 0.5], device=dev)

    calls = dict(
        clahe=lambda: im.clahe(img, clip),
        pyramid=lambda: im.build_pyramid(eq, 4)[1:],
        pyr_down=lambda: im.pyr_down(eq),
        scharr=lambda: im.scharr_gradients(img),
        blur=lambda: im.gaussian_blur(img, 2.0, 4), **tail_calls(dev))
    # the yardstick: (input, taps as one (out, 1, k, k) weight, stride,
    # the kernel call whose output it computes)
    yard = {"pyr_down": (eq, torch.outer(pyr, pyr)[None, None], 2),
            "blur": (img, torch.outer(g, g)[None, None], 1),
            "scharr": (img, torch.stack([torch.outer(smooth, diff),
                                         torch.outer(diff, smooth)])[:, None],
                       1)}
    for name, (x, w, s) in yard.items():
        r = w.shape[-1] // 2
        padded = F.pad(x[None, None], (r, r, r, r), mode="replicate")
        calls[f"conv2d {name}"] = (
            lambda p=padded, w=w, s=s: F.conv2d(p, w, stride=s))
        calls[f"pad {name}"] = (
            lambda x=x, r=r: F.pad(x[None, None], (r, r, r, r),
                                   mode="replicate"))

    if args.only:
        calls = {k: v for k, v in calls.items() if k in args.only}
        yard = {k: v for k, v in yard.items() if f"conv2d {k}" in calls}
    rows = {}
    for name, fn in calls.items():
        kern, dev_us = trace_call(fn, args.calls)
        row = dict(kernels=kern, device_us_per_call=dev_us,
                   queued_ms=chip_smoke.time_cuda_queued(fn, args.calls),
                   host_ms=chip_smoke.time_cuda(fn, args.calls),
                   launches=wrapper_launches(fn))
        if not name.startswith(("conv2d", "pad")):
            row["digest"] = digest(fn())
        rows[name] = row
    for name in yard:
        ref = calls[name]() if name in calls else None
        if ref is None:
            continue
        ref = torch.stack(list(ref)) if isinstance(ref, tuple) else ref
        out = calls[f"conv2d {name}"]()[0]
        rows[f"conv2d {name}"]["max_abs_diff_to_kernel"] = float(
            (out - ref.reshape(out.shape)).abs().max())
    chains = {name: 8 * (rows[f"{name} 72"]["queued_ms"]
                         - rows[name]["queued_ms"]) / 64
              for name in ("undistort", "tail")
              if name in rows and f"{name} 72" in rows}
    print(json.dumps(dict(label=args.label, device=nvidia_smi_line(),
                          torch=torch.__version__, calls=args.calls,
                          rows=rows, chains=chains)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
