"""Utility launcher: ``python -m mitsuba_tpu_torch.mtsutil <utility> [...]``
(port of ``mitsuba_tpu/mtsutil.py``).

* ``kdbench`` -- ray-throughput benchmark of the acceleration structure over
  a mesh: coherent (camera-grid) and incoherent (bounding-sphere chord)
  batches through the treelet kernel K7 and the lane-resort query of K3,
  printing Mrays/s and the hit rate of each (utils/kdbench.cpp:30-64).

The other utilities of the JAX launcher raise NotImplementedError: they land
in a later slice of the port.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .accel.build import build_bvh, treelet_roots, triangle_aabbs
from .device import resolve_device
from .io.mesh import load_mesh, load_obj
from .ops import cuda_bvh
from .render.scene import TREELET_MAX_NODES


def _later(name):
    def run(argv):
        raise NotImplementedError(
            f"mtsutil {name} lands in a later slice of the port")
    return run


def _rays(center, radius, R, seed=0):
    """The JAX kdbench's two batches (mitsuba_tpu/mtsutil.py:177-194):
    coherent camera-grid rays, then incoherent chords through the bounding
    sphere; float32 (o, d) pairs."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(R, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    w = rng.normal(size=(R, 3))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    o_inc = (center + radius * 1.2 * u).astype(np.float32)
    d_inc = center + radius * 0.8 * w - o_inc
    d_inc /= np.linalg.norm(d_inc, axis=1, keepdims=True)
    side = int(np.sqrt(R))
    px, py = np.meshgrid(np.linspace(-.5, .5, side), np.linspace(-.5, .5, side))
    eye = center + np.array([0, 0.4 * radius, 2.5 * radius])
    fwd = center - eye
    fwd /= np.linalg.norm(fwd)
    rt = np.cross(fwd, [0, 1, 0])
    rt /= np.linalg.norm(rt)
    up = np.cross(rt, fwd)
    d_coh = (fwd[None] + 0.7 * (px.ravel()[:, None] * rt[None]
             + py.ravel()[:, None] * up[None]))
    d_coh = np.pad(d_coh, ((0, R - len(d_coh)), (0, 0)), mode="edge")
    d_coh /= np.linalg.norm(d_coh, axis=1, keepdims=True)
    o_coh = np.broadcast_to(eye, (R, 3)).astype(np.float32)
    return (("coherent  ", o_coh, d_coh.astype(np.float32)),
            ("incoherent", o_inc, d_inc.astype(np.float32)))


def kdbench(argv, device=None):
    """Load a mesh, build its BVH and treelet cut, and time the treelet
    query (K7) and the lane-resort query (K3) on 2^18 coherent and 2^18
    incoherent rays. Runs on CUDA unless ``device`` names another device;
    times by host clock around calls that end in a synchronize."""
    ap = argparse.ArgumentParser(prog="mtsutil kdbench")
    ap.add_argument("mesh", help=".ply/.obj/.serialized mesh file")
    ap.add_argument("-n", "--rays", type=int, default=1 << 18)
    ap.add_argument("-r", "--repeat", type=int, default=3)
    a = ap.parse_args(argv)
    dev = resolve_device(device)

    meshes = (load_obj(a.mesh) if a.mesh.endswith(".obj")
              else [load_mesh(a.mesh)])
    v = np.concatenate([m.positions for m in meshes]).astype(np.float32)
    offs, f = 0, []
    for m in meshes:
        f.append(m.faces + offs)
        offs += len(m.positions)
    f = np.concatenate(f).astype(np.int32)
    p0 = v[f[:, 0]]
    e1 = v[f[:, 1]] - p0
    e2 = v[f[:, 2]] - p0
    lo, hi = triangle_aabbs(p0, p0 + e1, p0 + e2)
    t0 = time.perf_counter()
    bvh = build_bvh(lo, hi)
    t_build = time.perf_counter() - t0
    n_nodes = len(bvh.lo)
    nodes = torch.as_tensor(cuda_bvh.pack_nodes(bvh, p0, e1, e2), device=dev)
    roots = treelet_roots(bvh, max_nodes=TREELET_MAX_NODES)
    tl = tuple(torch.as_tensor(x, device=dev) for x in (
        roots, bvh.skip[roots].astype(np.int32), bvh.lo[roots], bvh.hi[roots]))
    slo, shi = lo.min(axis=0), hi.max(axis=0)
    center, radius = (slo + shi) / 2, 0.5 * np.linalg.norm(shi - slo)
    bounds = tuple(torch.as_tensor(x.astype(np.float32), device=dev)
                   for x in (slo, shi))
    print(f"{a.mesh}: {len(p0)} tris, {n_nodes} nodes, "
          f"{len(roots)} treelets, build {t_build*1e3:.0f} ms")

    R = a.rays
    tmin = torch.zeros(R, device=dev)
    tmax = torch.full((R,), torch.inf, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for tag, o_np, d_np in _rays(center, radius, R):
        o = torch.as_tensor(o_np, device=dev)
        d = torch.as_tensor(d_np, device=dev)
        for kern, kname in (
            (lambda: cuda_bvh.bvh_traverse_treelets(
                nodes, *tl, o, d, tmin, tmax, *bounds), "treelet"),
            (lambda: cuda_bvh.bvh_traverse_lane_resort(
                nodes, n_nodes, o, d, tmin, tmax, *bounds), "lane-resort"),
        ):
            out = kern()
            sync()
            t0 = time.perf_counter()
            for _ in range(a.repeat):
                out = kern()
            sync()
            dt = (time.perf_counter() - t0) / a.repeat
            hr = float(out[0].float().mean())
            print(f"  {tag} {kname:11s}: {R/dt/1e6:8.2f} Mrays/s  "
                  f"(hit rate {hr:.3f})")
    return 0


UTILITIES = {"tonemap": _later("tonemap"), "addimages": _later("addimages"),
             "joinrgb": _later("joinrgb"), "kdbench": kdbench,
             "rdielprec": _later("rdielprec"), "cylclip": _later("cylclip"),
             "preview": _later("preview")}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in UTILITIES:
        print("usage: python -m mitsuba_tpu_torch.mtsutil "
              f"{{{','.join(UTILITIES)}}} [args...]", file=sys.stderr)
        return 2
    return UTILITIES[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
