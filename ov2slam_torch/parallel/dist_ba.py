"""Distributed Schur bundle adjustment: observations sharded by landmark.

Port of ``ov2slam_tpu/parallel/dist_ba.py``, the scaling path for maps too
large for one BA window. Observations (and their landmark blocks) are
partitioned over shards by landmark; every shard does the Gauss-Newton
block accumulations and the per-landmark Schur elimination of its own
landmarks; only the reduced camera system is summed across shards, and the
(Kw·6)² system is solved on every rank; landmark back-substitution stays
with the shard.

Summed per LM iteration, independent of the observation count: Hpp
(Kw,6,6), bp (Kw,6), S_corr (Kw,Kw,6,6), b_corr (Kw,6) and the two costs.

Where the JAX package maps one shard onto each device of a mesh
(``shard_map`` and ``psum``), the port's step works on a leading shard
axis of any size ``s >= 1``: each shard's landmark indices are offset by
``shard × per_lm``, so one set of launches serves all of them, and the
per-shard partial sums go through the reduction of a :class:`ShardMesh`:

- in-process (``group`` None): summed over the shard axis, which is what
  runs on one card at any shard count;
- across processes: each rank holds its own rows of the shard axis, sums
  them and ``all_reduce``s one flat buffer over a ``torch.distributed``
  group (gloo for CPU ranks, NCCL for one card per rank).

Every scatter-add is a ``SegmentSum`` sorted once per solve, so two runs
of one problem agree to the last bit. f32 throughout with TF32 off
(``device.py``): the JAX step forces "highest" matmul precision because
normal equations at bf16 diverged (mean |t| error 0.017 → 0.122 m).
"""

from __future__ import annotations

import heapq
import os
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..solvers.ba import (BAParams, _huber_weight, _residuals_jacobians,
                          _robust_cost)
from ..solvers.segment import SegmentSum
from ..utils import lie


def init_multihost(init_method: Optional[str] = None,
                   world_size: Optional[int] = None,
                   rank: Optional[int] = None,
                   device=None) -> bool:
    """Start the default ``torch.distributed`` process group of a
    multi-process run.

    Does nothing when a group already exists, or when nothing is
    configured: no ``init_method`` (``tcp://`` or ``file://``) and no
    ``MASTER_ADDR`` in the environment — a single-process run. Without
    ``init_method`` the group comes from the environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); ``world_size`` and ``rank``
    default to those variables. The backend follows the rank's device
    (``None`` = the GPU): NCCL on CUDA, gloo on the CPU. Returns whether a
    group is initialized.
    """
    if not dist.is_available():
        return False
    if dist.is_initialized():
        return True
    if init_method is None and not os.environ.get("MASTER_ADDR"):
        return False
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else int(world_size),
        rank=-1 if rank is None else int(rank))
    return True


class ShardMesh(NamedTuple):
    """The shard axis and where it lives: ``n_shards`` shards in all,
    split evenly over the ranks of ``group`` in rank order (``None``: all
    of them in this process)."""

    n_shards: int
    group: Optional[object] = None

    @property
    def world_size(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def local_shards(self) -> int:
        return self.n_shards // self.world_size

    def reduce(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """Σ over every shard of each partial (``(local_shards, ...)``
        here): this process's shards summed over the leading axis, then,
        with a group, one ``all_reduce`` of them all as one flat buffer.
        The sums are taken in f64 and rounded to the partials' dtype once,
        so the result does not hang on the order in which shards and
        ranks are added (the backend's algorithm picks that order)."""
        sums = [p.to(torch.float64).sum(0) for p in parts]
        if self.group is not None:
            flat = torch.cat([x.reshape(-1) for x in sums])
            dist.all_reduce(flat, group=self.group)
            sums = [o.reshape(x.shape) for o, x in zip(
                torch.split(flat, [x.numel() for x in sums]), sums)]
        return [x.to(p.dtype) for x, p in zip(sums, parts)]

    def gather(self, rows: torch.Tensor) -> torch.Tensor:
        """Every rank's ``rows`` (equal shapes) stacked in rank order."""
        if self.group is None:
            return rows
        parts = [torch.empty_like(rows) for _ in range(self.world_size)]
        dist.all_gather(parts, rows.contiguous(), group=self.group)
        return torch.cat(parts)


def make_mesh(n_shards: int, group=None) -> ShardMesh:
    """A 1-D observation-shard axis of ``n_shards`` shards, in this
    process or spread evenly over the ranks of ``group`` (a
    ``torch.distributed`` process group, e.g.
    ``torch.distributed.group.WORLD``)."""
    world = 1 if group is None else dist.get_world_size(group)
    n = int(n_shards)
    if n < 1 or n % world:
        raise ValueError(f"{n} shards do not split evenly over {world} "
                         "ranks")
    return ShardMesh(n, group)


def balanced_lm_assignment(obs_lm, obs_valid, Lw: int, n_shards: int):
    """Greedy load-balanced landmark→shard assignment.

    Landmarks are sorted by observation count (descending) and assigned
    to the least-loaded shard (LPT bin packing) — a contiguous-block
    split pads every shard to the densest one, which multiplies compute
    under skewed covisibility.

    Returns (shard_of_lm (Lw,), per-shard obs loads (n_shards,)).
    """
    counts = np.bincount(obs_lm[obs_valid], minlength=Lw)[:Lw]
    order = np.argsort(-counts, kind="stable")
    shard_of_lm = np.zeros(Lw, np.int32)
    loads = np.zeros(n_shards, np.int64)
    heap = [(0, s) for s in range(n_shards)]
    heapq.heapify(heap)
    for l in order:
        load, s = heapq.heappop(heap)
        shard_of_lm[l] = s
        heapq.heappush(heap, (load + int(counts[l]), s))
        loads[s] = load + int(counts[l])
    return shard_of_lm, loads


def shard_ba_problem(prob, n_shards: int):
    """Partition a BAProblem's observations by landmark so each shard owns
    a load-balanced landmark subset plus all its observations (landmarks
    never cross shards → Schur elimination stays shard-local).

    Returns dict of numpy arrays with a leading shard axis:
    obs_* (S, per_obs), lm_pos (S, per_lm, 3), lm_ids (S, per_lm) global
    landmark window indices for un-sharding (-1 pad).
    """
    Lw = len(prob.lm_ids)
    shard_of_lm, loads = balanced_lm_assignment(
        np.maximum(prob.obs_lm, 0), prob.obs_valid, Lw, n_shards)

    # per-shard landmark lists (padded to the max)
    lm_lists = [np.nonzero(shard_of_lm == s)[0] for s in range(n_shards)]
    per_lm = max(1, max(len(x) for x in lm_lists))
    lm_pos = np.zeros((n_shards, per_lm, 3), np.float32)
    lm_ids = np.full((n_shards, per_lm), -1, np.int32)
    lm_local = np.zeros(Lw, np.int32)       # window lm idx -> local idx
    for s, ls in enumerate(lm_lists):
        lm_pos[s, : len(ls)] = prob.lm_pos[ls]
        lm_ids[s, : len(ls)] = ls
        lm_local[ls] = np.arange(len(ls), dtype=np.int32)

    obs_shard = shard_of_lm[np.maximum(prob.obs_lm, 0)]
    per_obs = max(8, int(loads.max()))

    obs_kf = np.full((n_shards, per_obs), -1, np.int32)
    obs_lm = np.full((n_shards, per_obs), 0, np.int32)
    obs_px = np.zeros((n_shards, per_obs, 2), np.float32)
    obs_cam = np.zeros((n_shards, per_obs), np.int8)
    obs_valid = np.zeros((n_shards, per_obs), bool)

    for s in range(n_shards):
        rows = np.nonzero(prob.obs_valid & (obs_shard == s))[0][:per_obs]
        n = len(rows)
        obs_kf[s, :n] = prob.obs_kf[rows]
        obs_lm[s, :n] = lm_local[prob.obs_lm[rows]]
        obs_px[s, :n] = prob.obs_px[rows]
        obs_cam[s, :n] = prob.obs_cam[rows]
        obs_valid[s, :n] = True

    return dict(obs_kf=obs_kf, obs_lm=obs_lm, obs_px=obs_px,
                obs_cam=obs_cam, obs_valid=obs_valid,
                lm_pos=lm_pos, lm_ids=lm_ids)


def shard_padding_overhead(shard_np) -> float:
    """Fraction of padded (wasted) observation rows across shards: the
    compute overhead the balanced assignment is meant to bound."""
    valid = shard_np["obs_valid"]
    return 1.0 - float(valid.sum()) / float(valid.size)


class DeviceShards(NamedTuple):
    """This process's rows of the shard axis, on one device, flattened to
    ``n = local shards`` blocks of ``per_obs`` observations and ``per_lm``
    landmarks. ``obs_lm`` indexes the flat (n·per_lm,) landmark axis
    (shard ``j``'s landmarks at ``j·per_lm``…); ``obs_kf`` is clamped to 0
    on padded rows, whose ``w_valid`` is 0. ``pose``, ``lm`` and ``lp``
    sum observation rows into (n·Kw), (n·per_lm) and (n·per_lm·Kw) bins."""

    n: int
    obs_kf: torch.Tensor
    obs_lm: torch.Tensor
    obs_px: torch.Tensor
    obs_cam: torch.Tensor
    w_valid: torch.Tensor
    lm_pos: torch.Tensor
    pose: SegmentSum
    lm: SegmentSum
    lp: SegmentSum


def put_sharded(mesh: ShardMesh, shard_np, n_kf: int,
                device=None) -> DeviceShards:
    """This rank's rows of the host shard arrays (``shard_ba_problem``)
    on ``device`` (``None`` = the GPU), for a window of ``n_kf`` poses.
    Each process uploads only its own shards."""
    dev = resolve_device(device)
    n = mesh.local_shards
    lo = mesh.rank * n
    rows = slice(lo, lo + n)
    per_obs = shard_np["obs_kf"].shape[1]
    per_lm = shard_np["lm_pos"].shape[1]
    shard = np.repeat(np.arange(n, dtype=np.int64), per_obs)
    obs_kf = np.maximum(shard_np["obs_kf"][rows].reshape(-1), 0)
    obs_kf = obs_kf.astype(np.int64)
    obs_lm = shard_np["obs_lm"][rows].reshape(-1) + shard * per_lm

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    obs_kf_t, obs_lm_t = t(obs_kf), t(obs_lm)
    return DeviceShards(
        n=n, obs_kf=obs_kf_t, obs_lm=obs_lm_t,
        obs_px=t(shard_np["obs_px"][rows].reshape(-1, 2)),
        obs_cam=t(shard_np["obs_cam"][rows].reshape(-1)),
        w_valid=t(shard_np["obs_valid"][rows].reshape(-1), torch.float32),
        lm_pos=t(shard_np["lm_pos"][rows].reshape(-1, 3)),
        pose=SegmentSum(t(shard * n_kf) + obs_kf_t, n * n_kf),
        lm=SegmentSum(obs_lm_t, n * per_lm),
        lp=SegmentSum(obs_lm_t * n_kf + obs_kf_t, n * per_lm * n_kf))


def _shard_costs(T_cw, points, sh: DeviceShards, params, robust_th):
    """Each shard's robust cost (n,) at (T_cw, points)."""
    r, _, _, depth_ok = _residuals_jacobians(
        T_cw, points, sh.obs_kf, sh.obs_lm, sh.obs_px, sh.obs_cam, params)
    chi2 = torch.sum(r * r, -1)
    rho = _robust_cost(chi2, robust_th) * sh.w_valid * depth_ok
    return rho.reshape(sh.n, -1).sum(1)


def shard_partials(T_cw, points, lam, sh: DeviceShards, free_pose,
                   params: BAParams, robust_th: float):
    """The shard-local half of one LM iteration, for every shard of
    ``sh`` at once: robust weights at the current state, the Gauss-Newton
    blocks and each shard's landmark elimination (the JAX package's
    ``_local_schur``).

    Returns ``(partials, local)``. ``partials`` are what the reduction
    sums, each with a leading shard axis: Hpp (n,Kw,6,6), bp (n,Kw,6),
    S_corr (n,Kw,Kw,6,6), b_corr (n,Kw,6) and the cost at the current
    state (n,). ``local`` = (Z (n·per_lm,Kw,6,3), Hll_inv (n·per_lm,3,3),
    bl (n·per_lm,3)) stays with the shards for back-substitution.
    """
    n, Kw = sh.n, T_cw.shape[0]
    L = points.shape[0]
    r, Jp, Jl, depth_ok = _residuals_jacobians(
        T_cw, points, sh.obs_kf, sh.obs_lm, sh.obs_px, sh.obs_cam, params)
    chi2 = torch.sum(r * r, -1)
    w_rob = (_huber_weight(chi2, robust_th) if robust_th > 0
             else torch.ones_like(chi2))
    w = sh.w_valid * w_rob * depth_ok
    cost = (_robust_cost(chi2, robust_th) * sh.w_valid
            * depth_ok).reshape(n, -1).sum(1)

    Jp = Jp * free_pose[sh.obs_kf][:, None, None]
    wJp = Jp * w[:, None, None]
    wJl = Jl * w[:, None, None]

    Hpp = sh.pose(torch.einsum("oik,oil->okl", wJp, Jp))
    Hll = sh.lm(torch.einsum("oik,oil->okl", wJl, Jl))
    bp = sh.pose(-torch.einsum("oik,oi->ok", wJp, r))
    bl = sh.lm(-torch.einsum("oik,oi->ok", wJl, r))

    eyeL = torch.eye(3, dtype=r.dtype, device=r.device)
    Hll_d = Hll + (lam * torch.clamp(torch.diagonal(Hll, dim1=-2, dim2=-1),
                                     min=1e-6))[..., None] * eyeL[None]
    Hll_inv, _ = torch.linalg.inv_ex(Hll_d + 1e-8 * eyeL[None])

    Wo = torch.einsum("oik,oil->okl", wJp, Jl)
    Z = sh.lp(Wo).reshape(L, Kw, 6, 3)
    ZH = torch.einsum("lkab,lbc->lkac", Z, Hll_inv)
    per_lm = L // n
    S_corr = torch.einsum("slkac,slqdc->skqad",
                          ZH.reshape(n, per_lm, Kw, 6, 3),
                          Z.reshape(n, per_lm, Kw, 6, 3))
    b_corr = torch.einsum("slkac,slc->ska", ZH.reshape(n, per_lm, Kw, 6, 3),
                          bl.reshape(n, per_lm, 3))
    return ((Hpp.reshape(n, Kw, 6, 6), bp.reshape(n, Kw, 6), S_corr,
             b_corr, cost), (Z, Hll_inv, bl))


def shard_step(T_cw, points, lam, sh: DeviceShards, free_pose,
               params: BAParams, robust_th: float,
               reduce: Callable[[List[torch.Tensor]], List[torch.Tensor]]):
    """One LM iteration: the shards' partials, summed by ``reduce`` (a
    :meth:`ShardMesh.reduce`), the damped reduced camera system with the
    gauge rows of fixed poses solved, the landmarks back-substituted on
    their shards, and the proposal's cost summed.

    Returns (new_T_cw, new_points, cost0, cost1)."""
    (Hpp, bp, S_corr, b_corr, cost0), (Z, Hll_inv, bl) = shard_partials(
        T_cw, points, lam, sh, free_pose, params, robust_th)
    Hpp, bp, S_corr, b_corr, cost0 = reduce([Hpp, bp, S_corr, b_corr,
                                             cost0])
    Kw = T_cw.shape[0]
    dt, dev = T_cw.dtype, T_cw.device

    eyeK = torch.eye(6, dtype=dt, device=dev)
    Hpp_d = Hpp + (lam * torch.clamp(torch.diagonal(Hpp, dim1=-2, dim2=-1),
                                     min=1e-6))[..., None] * eyeK[None]
    ar = torch.arange(Kw, device=dev)
    S = -S_corr
    S[ar, ar] += Hpp_d
    fp = free_pose > 0
    S = torch.where((fp[:, None] & fp[None, :])[..., None, None], S,
                    torch.zeros_like(S))
    S[ar, ar] += (1.0 - free_pose)[:, None, None] * eyeK[None]
    b_schur = (bp - b_corr) * free_pose[:, None]

    Sd = S.permute(0, 2, 1, 3).reshape(Kw * 6, Kw * 6)
    dx_pose, _ = torch.linalg.solve_ex(
        Sd + 1e-6 * torch.eye(Kw * 6, dtype=dt, device=dev),
        b_schur.reshape(Kw * 6, 1))
    dx_pose = dx_pose.reshape(Kw, 6)

    # shard-local landmark back-substitution
    corr = torch.einsum("lkab,ka->lb", Z, dx_pose)
    dx_lm = torch.einsum("lab,lb->la", Hll_inv, bl - corr)
    new_T_cw = lie.pose_left_update(T_cw, dx_pose * free_pose[:, None])
    new_points = points + dx_lm
    (cost1,) = reduce([_shard_costs(new_T_cw, new_points, sh, params,
                                    robust_th)])
    return new_T_cw, new_points, cost0, cost1


def _params_on(params: BAParams, dev) -> BAParams:
    return BAParams(*(p.to(dev, torch.float32) for p in params[:5]),
                    intr=params.intr)


def make_distributed_ba(mesh: ShardMesh, params: BAParams,
                        robust_th: float, iters: int):
    """The distributed BA solve for ``mesh``:
    ``step(kf_poses, kf_fixed, shards) -> (new_poses (Kw,7), new_lm_pos
    (local_shards·per_lm, 3), final_cost)``, all tensors on the shards'
    device. ``iters`` LM iterations in a Python loop that accepts or
    rejects with ``torch.where``: the loop reads nothing back to the host.
    The cost is the last proposal's, accepted or not, as in the JAX
    package."""

    def step(kf_poses, kf_fixed, shards: DeviceShards):
        dev = shards.lm_pos.device
        prm = _params_on(params, dev)
        f32 = torch.float32
        T_cw = lie.pose_inverse(kf_poses.to(dev, f32))
        free = (~kf_fixed.to(dev)).to(f32)
        points = shards.lm_pos
        lam = torch.tensor(1e-3, dtype=f32, device=dev)
        cost = torch.zeros((), dtype=f32, device=dev)
        for _ in range(iters):
            T_new, p_new, c0, cost = shard_step(
                T_cw, points, lam, shards, free, prm, robust_th,
                mesh.reduce)
            accept = cost < c0
            T_cw = torch.where(accept, T_new, T_cw)
            points = torch.where(accept, p_new, points)
            lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-6),
                              torch.clamp(lam * 4.0, max=1e2))
        return lie.pose_inverse(T_cw), points, cost

    return step


def distributed_ba_solve(mesh, prob, params: BAParams,
                         robust_th: float = 5.9915, iters: int = 5,
                         device=None):
    """Host entry: shard a BAProblem over ``mesh`` (a :class:`ShardMesh`,
    or a shard count for in-process shards) and solve on ``device``
    (``None`` = the GPU; with a group, the device this rank's backend
    reduces on).

    Returns (new_kf_poses (Kw, 7) np, new_lm_pos (Lw, 3) np, cost) on
    every rank.
    """
    if not isinstance(mesh, ShardMesh):
        mesh = make_mesh(int(mesh))
    shard_np = shard_ba_problem(prob, mesh.n_shards)
    shards = put_sharded(mesh, shard_np, len(prob.kf_ids), device)
    dev = shards.lm_pos.device
    step = make_distributed_ba(mesh, params, robust_th, iters)
    poses, lm_local, cost = step(torch.as_tensor(prob.kf_poses, device=dev),
                                 torch.as_tensor(prob.kf_fixed, device=dev),
                                 shards)

    # un-shard landmarks back to the window's flat order via the global
    # index map (balanced assignment is NOT contiguous)
    lm = mesh.gather(lm_local).cpu().numpy()
    ids = shard_np["lm_ids"].reshape(-1)
    out = np.array(prob.lm_pos)
    sel = ids >= 0
    out[ids[sel]] = lm[sel]
    return poses.cpu().numpy(), out, float(cost)
