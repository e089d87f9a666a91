"""The 5-point constraint stage's rounding on five loop-closure samples.

``csrc/essential_ransac.cu`` forms the ten constraint rows from the f32
null space, solves their 10x10 system by LU with partial pivoting and
forms det B. In f32 that stage lost a root's digits on samples that slice
B's loop closer drew on the card (the slots of the first loop-closure call
that sat farthest from an f64 solve). This script runs the kernel's CPU
mirror (``tests/test_torch_pose_kernels.py``: its Householder null space,
LU, grid roots and bisection) on those samples with the stage arranged
several ways, and prints each root's distance from the f64 plain solve
(``geometry/essential.five_point`` in f64), the nearest of the
arrangement's ten candidates, sign-free:

- ``f32``: the stage in f32 (the kernel's earlier form);
- ``f64``: the stage in f64 from the f32 null space, B and det B rounded
  back to f32 (the kernel's form);
- ``f32_rows``: f32, each row of the system scaled by its largest entry;
- ``f32_cols``: f32, each column scaled by its largest entry;
- ``f32_refine``: f32, then one step of refinement on an f64 residual;
- ``plain_f32``: the plain version (``five_point``) in f32 on the CPU.

    python3 ransac_rounding.py
"""

from __future__ import annotations

import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))

ARRANGEMENTS = ("f32", "f64", "f32_rows", "f32_cols", "f32_refine",
                "plain_f32")

# (sample, root, x_l (5, 2), x_r (5, 2)) of slice B's first loop-closure
# RANSAC call on the card (128 rows, 1000 5-point samples)
SAMPLES = (
    (169, 5,
     [(0.6671547889709473, -0.12426651269197464),
      (-0.12771765887737274, -0.2614893913269043),
      (-0.41948607563972473, -0.22936475276947021),
      (0.23586423695087433, -0.010560214519500732),
      (0.23586423695087433, -0.010560214519500732)],
     [(0.2875424921512604, 0.18020915985107422),
      (-0.006337061524391174, -0.256287157535553),
      (0.2671290338039398, -0.3243108093738556),
      (-0.2322869449853897, -0.42784741520881653),
      (0.10029122233390808, -0.14174261689186096)]),
    (248, 1,
     [(0.0004856159503106028, -0.36658042669296265),
      (-0.21119309961795807, 0.367840975522995),
      (-0.04513169825077057, 0.272708535194397),
      (0.5212110280990601, 0.2882416546344757),
      (-0.10709290951490402, -0.13026447594165802)],
     [(0.73001629114151, -0.32447394728660583),
      (-0.3783899247646332, 0.038359928876161575),
      (0.3452380299568176, -0.347045361995697),
      (0.3577289283275604, -0.1413400024175644),
      (0.2453124225139618, 0.24841268360614777)]),
    (437, 3,
     [(0.5879981517791748, -0.18646599352359772),
      (0.7529098391532898, -0.18318629264831543),
      (0.10267865657806396, 0.452042818069458),
      (-0.6784148216247559, 0.39287877082824707),
      (0.516809344291687, -0.1486385017633438)],
     [(-0.2662031054496765, 0.3854861855506897),
      (-0.7717829942703247, -0.21358703076839447),
      (0.5175593495368958, 0.46198517084121704),
      (0.4748908281326294, 0.10918229818344116),
      (-0.7314206957817078, -0.16715094447135925)]),
    (438, 2,
     [(0.13926896452903748, 0.317685604095459),
      (-0.17854362726211548, -0.08844290673732758),
      (0.7548023462295532, 0.022809958085417747),
      (0.7529098391532898, -0.18318629264831543),
      (0.6671547889709473, -0.12426651269197464)],
     [(0.18493172526359558, -0.39341893792152405),
      (0.5814622044563293, -0.43001672625541687),
      (-0.7704249620437622, 0.027721522375941277),
      (-0.7717829942703247, -0.21358703076839447),
      (0.2875424921512604, 0.18020915985107422)]),
    (955, 3,
     [(0.0004856159503106028, -0.36658042669296265),
      (-0.2312706708908081, 0.15116016566753387),
      (0.05898361653089523, -0.12004062533378601),
      (-0.41948607563972473, -0.22936475276947021),
      (-0.2312706708908081, 0.15116016566753387)],
     [(0.73001629114151, -0.32447394728660583),
      (-0.1362208127975464, -0.04698777571320534),
      (0.42951613664627075, 0.28467389941215515),
      (0.2671290338039398, -0.3243108093738556),
      (-0.05325557291507721, 0.3603515625)]),
)


def _candidates(x_l, x_r, arrangement):
    """(10, 9) normalised candidates of one sample (the kernel's mirror
    with the constraint stage arranged as ``arrangement``)."""
    import test_torch_pose_kernels as tp

    from ov2slam_torch.geometry import essential as te

    xl, xr = x_l[None], x_r[None]
    if arrangement == "plain_f32":
        E, _ = te.five_point(xl, xr)
        return E.reshape(10, 9)
    null = tp.householder_null_space(tp._design(xl, xr).transpose(-2, -1))
    basis = null.transpose(-2, -1).reshape(1, 4, 3, 3)
    stage = torch.float64 if arrangement == "f64" else torch.float32
    M = te._nister_constraints(basis.to(stage))
    A, B = M[..., :10], M[..., 10:]
    if arrangement == "f32_rows":
        s = A.abs().amax(-1, keepdim=True)
        P = tp.lu_solve(A / s, B / s)
    elif arrangement == "f32_cols":
        c = A.abs().amax(-2, keepdim=True)
        P = tp.lu_solve(A / c, B) / c.transpose(-2, -1)
    elif arrangement == "f32_refine":
        P = tp.lu_solve(A, B)
        R = B.double() - A.double() @ P.double()
        P = P + tp.lu_solve(A, R.float())
    else:
        P = tp.lu_solve(A, B)
    detB, Bz = te._nister_detB(P)
    detB = detB.float()
    Bz = [[Bz[i][j].float() for j in range(3)] for i in range(3)]
    z, _ = tp.real_roots_mirror(detB)
    b = [[te._polyval(Bz[i][j], z) for j in range(3)] for i in range(2)]
    den = b[0][0] * b[1][1] - b[0][1] * b[1][0]
    x = (-b[0][2] * b[1][1] + b[0][1] * b[1][2]) / den
    y = (-b[0][0] * b[1][2] + b[0][2] * b[1][0]) / den
    bs = basis[:, None]
    E = (x[..., None, None] * bs[:, :, 0] + y[..., None, None] * bs[:, :, 1]
         + z[..., None, None] * bs[:, :, 2] + bs[:, :, 3])
    E = E / torch.linalg.norm(E.flatten(-2), dim=-1)[..., None, None]
    return E.reshape(10, 9)


def root_errors(arrangement):
    """Per sample of :data:`SAMPLES`, the distance of the f64 solve's root
    from the nearest candidate of ``arrangement`` (max abs entry)."""
    from ov2slam_torch.geometry import essential as te

    out = []
    for _, k, x_l, x_r in SAMPLES:
        x_l, x_r = torch.tensor(x_l), torch.tensor(x_r)
        ref, _ = te.five_point(x_l[None].double(), x_r[None].double())
        r = ref.reshape(10, 9)[k]
        c = _candidates(x_l, x_r, arrangement).double()
        d = torch.minimum((c - r).abs().amax(-1), (c + r).abs().amax(-1))
        d = torch.where(torch.isfinite(d), d, torch.full_like(d, torch.inf))
        out.append(float(d.min()))
    return out


def main() -> int:
    torch.set_num_threads(1)
    for a in ARRANGEMENTS:
        errs = root_errors(a)
        print(json.dumps(dict(arrangement=a, samples=[s[0] for s in SAMPLES],
                              root_err=errs, worst=max(errs))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
