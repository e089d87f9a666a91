"""Visualization & export — ROS-free replacement for `RosVisualizer` +
`CameraPoseVisualization` (`include/ros_visualizer.hpp:61-311`,
`src/camera_visualizer.cpp`).

The reference publishes live RViz topics (tracked-keypoint overlay image,
VO/KF trajectories, camera frustum markers, landmark point cloud). Here
the same artifacts are produced as files: PNG overlays, PLY point clouds /
trajectory line sets (loadable in MeshLab/CloudCompare/Open3D), so the
products are inspectable without any middleware.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..utils import lie_np

# kp class colors, mirroring the reference's overlay color coding
# (`ov2slam.cpp:490-512`): 3D kps green, 2D blue, retracked yellow
COLOR_3D = (0, 255, 0)
COLOR_2D = (80, 130, 255)
COLOR_BAD = (255, 60, 60)


def draw_tracks(img: np.ndarray, kps: np.ndarray, valid: np.ndarray,
                is3d: Optional[np.ndarray] = None,
                radius: int = 3) -> np.ndarray:
    """Tracked-keypoint overlay (pubTrackImage equivalent).

    img: (H, W) grayscale f32 [0,255] → returns (H, W, 3) uint8.
    """
    H, W = img.shape
    out = np.repeat(np.clip(img, 0, 255).astype(np.uint8)[:, :, None], 3, 2)
    if is3d is None:
        is3d = np.zeros(len(kps), bool)
    yy, xx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    ring = (np.abs(yy**2 + xx**2 - radius**2) <= radius)
    ys, xs = np.nonzero(ring)
    for i in np.nonzero(valid)[0]:
        u, v = int(round(kps[i, 0])), int(round(kps[i, 1]))
        if not (radius <= u < W - radius and radius <= v < H - radius):
            continue
        color = COLOR_3D if is3d[i] else COLOR_2D
        out[v + ys - radius, u + xs - radius] = color
    return out


def save_png(img: np.ndarray, path: str):
    from PIL import Image

    if img.ndim == 2:
        img = np.clip(img, 0, 255).astype(np.uint8)
    Image.fromarray(img).save(path)


def export_ply(points: np.ndarray, path: str,
               colors: Optional[np.ndarray] = None,
               edges: Optional[np.ndarray] = None):
    """ASCII PLY writer: point cloud (+ optional uint8 colors, edges)."""
    points = np.asarray(points, np.float32)
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        if edges is not None:
            f.write(f"element edge {len(edges)}\n")
            f.write("property int vertex1\nproperty int vertex2\n")
        f.write("end_header\n")
        for i in range(n):
            row = f"{points[i,0]:.5f} {points[i,1]:.5f} {points[i,2]:.5f}"
            if colors is not None:
                c = colors[i]
                row += f" {int(c[0])} {int(c[1])} {int(c[2])}"
            f.write(row + "\n")
        if edges is not None:
            for e in edges:
                f.write(f"{int(e[0])} {int(e[1])}\n")


def export_map_cloud(map_store, path: str):
    """Landmark point cloud (pubPointCloud equivalent,
    `map_manager.cpp:646-660`)."""
    sel = map_store.lm_valid & map_store.lm_is3d
    pts = map_store.lm_pos[sel]
    export_ply(pts, path)
    return int(sel.sum())


def camera_frustum_points(T_wc: np.ndarray, scale: float = 0.1) -> np.ndarray:
    """5 frustum corner points in world frame (CameraPoseVisualization
    geometry, `camera_visualizer.cpp`)."""
    corners = np.array([
        [0.0, 0.0, 0.0],
        [-1.0, -0.75, 1.5], [1.0, -0.75, 1.5],
        [1.0, 0.75, 1.5], [-1.0, 0.75, 1.5],
    ]) * scale
    return lie_np.pose_apply(np.asarray(T_wc, np.float64), corners)


_FRUSTUM_EDGES = [(0, 1), (0, 2), (0, 3), (0, 4),
                  (1, 2), (2, 3), (3, 4), (4, 1)]


def export_trajectory_ply(poses: Sequence[np.ndarray], path: str,
                          frustum_every: int = 5, scale: float = 0.1):
    """Trajectory polyline + periodic camera frustums as a PLY edge set
    (pubVisualKFs / VO marker trajectory equivalent)."""
    verts = []
    edges = []
    for i, T in enumerate(poses):
        verts.append(np.asarray(T[4:7], np.float64))
        if i > 0:
            edges.append((len(verts) - 2, len(verts) - 1))
    base = len(verts)
    for i in range(0, len(poses), max(frustum_every, 1)):
        pts = camera_frustum_points(poses[i], scale)
        off = len(verts)
        verts.extend(pts)
        edges.extend([(off + a, off + b) for a, b in _FRUSTUM_EDGES])
    export_ply(np.asarray(verts), path, edges=np.asarray(edges))


# --------------------------------------------------------------------- #
# interactive HTML viewer — the `python_files/open3d_visualize_pose.py`
# role (trajectory polyline + camera frusta + landmark cloud in an
# orbitable 3D view) without the open3d/GUI dependency: one
# self-contained file, vanilla-JS canvas renderer, open in any browser.
# --------------------------------------------------------------------- #

_VIEWER_JS = r"""
const D = window.SLAM_DATA;
const cv = document.getElementById('c');
const ctx = cv.getContext('2d');
let W, H; function rs(){W=cv.width=innerWidth;H=cv.height=innerHeight;draw();}
let yaw=-0.6, pitch=-0.45, dist=0, cx=0, cy=0, cz=0, panx=0, pany=0;
// center + scale from trajectory bounds
(function(){
  const t=D.traj; let mn=[1e9,1e9,1e9], mx=[-1e9,-1e9,-1e9];
  for(const p of t){for(let k=0;k<3;k++){mn[k]=Math.min(mn[k],p[k]);mx[k]=Math.max(mx[k],p[k]);}}
  cx=(mn[0]+mx[0])/2; cy=(mn[1]+mx[1])/2; cz=(mn[2]+mx[2])/2;
  dist=2.5*Math.max(mx[0]-mn[0],mx[1]-mn[1],mx[2]-mn[2],1e-3);
})();
function proj(p){
  let x=p[0]-cx, y=p[1]-cy, z=p[2]-cz;
  let x1=x*Math.cos(yaw)+z*Math.sin(yaw), z1=-x*Math.sin(yaw)+z*Math.cos(yaw);
  let y1=y*Math.cos(pitch)-z1*Math.sin(pitch), z2=y*Math.sin(pitch)+z1*Math.cos(pitch);
  let zc=z2+dist; if(zc<1e-3) return null;
  const f=0.9*Math.min(W,H);
  return [W/2+f*x1/zc+panx, H/2+f*y1/zc+pany, zc];
}
function line(a,b,st,w){const A=proj(a),B=proj(b); if(!A||!B)return;
  ctx.strokeStyle=st; ctx.lineWidth=w||1; ctx.beginPath();
  ctx.moveTo(A[0],A[1]); ctx.lineTo(B[0],B[1]); ctx.stroke();}
function draw(){
  ctx.fillStyle='#101014'; ctx.fillRect(0,0,W,H);
  // landmark cloud, depth-tinted
  for(const p of D.points){const P=proj(p); if(!P)continue;
    const s=Math.max(1, 3-P[2]/dist*2);
    ctx.fillStyle=`hsl(${180+40*Math.sin(p[1])},60%,${Math.max(25,70-P[2]/dist*40)}%)`;
    ctx.fillRect(P[0],P[1],s,s);}
  // trajectory polyline
  for(let i=1;i<D.traj.length;i++) line(D.traj[i-1],D.traj[i],'#ff5050',2);
  // keyframe frusta
  const E=[[0,1],[0,2],[0,3],[0,4],[1,2],[2,3],[3,4],[4,1]];
  for(const f of D.frusta) for(const e of E) line(f[e[0]],f[e[1]],'#40c0ff',1);
  // loop-closure edges
  for(const e of (D.lc||[])) line(D.traj[e[0]],D.traj[e[1]],'#ffe050',1.5);
  ctx.fillStyle='#aaa'; ctx.font='12px monospace';
  ctx.fillText(`${D.traj.length} poses  ${D.points.length} landmarks  `+
               `${D.frusta.length} KF frusta  drag=orbit wheel=zoom shift-drag=pan`,10,18);
}
let drag=false,px=0,py=0,shift=false;
cv.onmousedown=e=>{drag=true;px=e.clientX;py=e.clientY;shift=e.shiftKey;};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return;
  const dx=e.clientX-px, dy=e.clientY-py; px=e.clientX; py=e.clientY;
  if(shift){panx+=dx;pany+=dy;} else {yaw+=dx*0.008; pitch+=dy*0.008;}
  draw();};
cv.onwheel=e=>{e.preventDefault(); dist*=Math.exp(e.deltaY*0.001); draw();};
window.onresize=rs; rs();
"""


def export_html_viewer(poses, map_store_or_points, path: str,
                       kf_poses=None, lc_pairs=None,
                       max_points: int = 60000,
                       frustum_scale: float = 0.12) -> str:
    """Interactive 3D map/trajectory viewer as ONE self-contained HTML
    file (no open3d, no network, no GUI dependency — open in a browser).

    Covers the reference's `python_files/open3d_visualize_pose.py` role:
    trajectory polyline, periodic camera frusta, landmark point cloud,
    orbit/zoom/pan. ``map_store_or_points`` is a MapStore (valid 3D
    landmarks are exported) or an (N, 3) array. ``lc_pairs`` draws
    loop-closure edges as (i, j) trajectory-index pairs.
    """
    import json as _json

    poses = np.asarray(poses, np.float64)
    traj = poses[:, 4:7]
    if hasattr(map_store_or_points, "lm_valid"):
        m = map_store_or_points
        pts = m.lm_pos[m.lm_valid & m.lm_is3d]
    else:
        pts = np.asarray(map_store_or_points, np.float64).reshape(-1, 3)
    if len(pts) > max_points:
        pts = pts[np.linspace(0, len(pts) - 1, max_points).astype(int)]
    fr_src = np.asarray(kf_poses, np.float64) if kf_poses is not None \
        else poses[:: max(len(poses) // 64, 1)]
    frusta = [camera_frustum_points(T, frustum_scale).round(4).tolist()
              for T in fr_src]
    data = dict(traj=traj.round(4).tolist(),
                points=pts.round(3).tolist(),
                frusta=frusta,
                lc=[[int(a), int(b)] for a, b in (lc_pairs or [])])
    html = ("<!doctype html><html><head><meta charset='utf-8'>"
            "<title>ov2slam_tpu map</title>"
            "<style>body{margin:0;overflow:hidden}</style></head><body>"
            "<canvas id='c'></canvas>"
            f"<script>window.SLAM_DATA={_json.dumps(data)};</script>"
            f"<script>{_VIEWER_JS}</script></body></html>")
    with open(path, "w") as f:
        f.write(html)
    return path
