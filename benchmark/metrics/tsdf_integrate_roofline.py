"""The integration kernel's share of its roofline, in %: the least time of
one integration at the cell's shapes (``peaks.tsdf_integrate_bound``: 40
bytes a voxel and the frame at the HBM peak) over the mean device time of
``tsdf_integrate_kernel`` in the trace. Nothing without such a kernel."""

from benchmark import peaks


def read(obs):
    tr, shape = obs.get("trace"), (obs.get("shapes") or {}).get(
        "tsdf_integrate")
    if not tr or not shape:
        return None
    us = [t for name, t in tr["kernels"] if "tsdf_integrate_kernel" in name]
    if not us:
        return None
    b = peaks.tsdf_integrate_bound(shape["V"], shape["H"], shape["W"],
                                   shape["color"], shape["const_weight"])
    return 100.0 * b["bound_ms"] / (1e-3 * sum(us) / len(us))
