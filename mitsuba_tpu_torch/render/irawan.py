"""Weave patterns of the Irawan-Marschner woven-cloth BSDF (port of
``mitsuba_tpu/render/irawan.py``; reference: src/bsdfs/irawan.{h,cpp}).

The BRDF itself is ``bsdf._irawan_eval``; this module owns the weave
pattern: a table of yarn segments per pattern, the per-lane lookup (uv ->
tile cell -> yarn -> the segment's local coordinates, irawan.cpp:200-230)
with the yarn-tension noise and the specular intensity variation, the
``.cloth`` file grammar (irawan.h:340-395), the plain-weave and 2/2 twill
presets (the reference ships no patterns), and the Monte-Carlo specular
normalization of IrawanClothBRDF::configure() (irawan.cpp:138-171).

The lookup's hashes (``_hash01``, the Perlin noise of ``core/noise.py``)
equal the JAX package's bit for bit. The normalization is a float32 sum
over 10,000 lanes of the port's own BRDF, so it can differ from the JAX
package's in its last bits; ``bridge.scene_from_arrays`` carries the JAX
table's value across.
"""
from __future__ import annotations

import re
from typing import NamedTuple

import numpy as np
import torch

from ..core import math as m
from ..core import noise as noise_mod
from ..core import rng as rng_mod
from ..core import warp
from . import bsdf as bsdf_mod

DEG = np.pi / 180.0


class IrawanTable(NamedTuple):
    """Stacked weave patterns, padded to common tile and yarn counts."""

    pattern: torch.Tensor    # (P, Hm, Wm) int32 0-based yarn ids
    tile_w: torch.Tensor     # (P,) int32
    tile_h: torch.Tensor     # (P,) int32
    yarns: torch.Tensor      # (P, Ym, 8): type, psi, umax, kappa, w, l, cU, cV
    yarn_kd: torch.Tensor    # (P, Ym, 3)
    yarn_ks: torch.Tensor    # (P, Ym, 3)
    meta: torch.Tensor       # (P, 12): alpha, beta, ss, hwidth, warpA, weftA,
                             # fineness, period, dWarpU/dWarp, dWarpU/dWeft,
                             # dWeftU/dWarp, dWeftU/dWeft
    repeat: torch.Tensor     # (P, 2) repeatU, repeatV
    spec_norm: torch.Tensor  # (P,)

    @staticmethod
    def empty(device) -> "IrawanTable":
        """The table of a scene without a weave pattern (one zero row)."""
        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        def one(*shape, dtype=torch.float32):
            return torch.ones(shape, dtype=dtype, device=device)

        return IrawanTable(
            pattern=z(1, 1, 1, dtype=torch.int32),
            tile_w=one(1, dtype=torch.int32), tile_h=one(1, dtype=torch.int32),
            yarns=z(1, 1, 8), yarn_kd=z(1, 1, 3), yarn_ks=z(1, 1, 3),
            meta=z(1, 12), repeat=one(1, 2), spec_norm=z(1))


# --- the built-in presets ----------------------------------------------------
# Plain weave: a 2x2 tile, warp and weft alternating over and under; 2/2
# twill: a 4x4 tile with the diagonal wale. The yarn geometry sits in the
# ranges the model was published with (umax 25-35 degrees, staple psi
# about 30 degrees).

def _yarn(kind, psi_deg, umax_deg, kappa, w, l, cu, cv, kd, ks):
    return dict(type=0 if kind == "warp" else 1, psi=psi_deg * DEG,
                umax=umax_deg * DEG, kappa=kappa, width=w, length=l,
                centerU=cu, centerV=cv, kd=kd, ks=ks)


def preset(name: str, kd=(0.3, 0.3, 0.3), ks=(0.4, 0.4, 0.4)) -> dict:
    """The pattern dict of a built-in weave ("plain" or "twill")."""
    if name == "plain":
        return dict(
            name="plain weave", tileWidth=2, tileHeight=2,
            alpha=0.05, beta=4.0, ss=0.5, hWidth=0.5,
            warpArea=0.5, weftArea=0.5,
            pattern=[1, 2, 3, 4],
            yarns=[
                _yarn("warp", 30, 30, 0.5, 1.0, 2.0, 0.25, 0.25, kd, ks),
                _yarn("weft", 30, 30, 0.5, 1.0, 2.0, 0.75, 0.25, kd, ks),
                _yarn("weft", 30, 30, 0.5, 1.0, 2.0, 0.25, 0.75, kd, ks),
                _yarn("warp", 30, 30, 0.5, 1.0, 2.0, 0.75, 0.75, kd, ks),
            ],
        )
    if name == "twill":
        # 2/2 twill: the warp floats over two and under two, advancing one
        pat = [1 + ((xx - yy) % 4 < 2) for yy in range(4) for xx in range(4)]
        return dict(
            name="2/2 twill", tileWidth=4, tileHeight=4,
            alpha=0.05, beta=4.0, ss=0.5, hWidth=0.5,
            warpArea=0.5, weftArea=0.5,
            pattern=pat,
            yarns=[
                _yarn("warp", 0, 35, 0.5, 1.0, 3.0, 0.5, 0.5, kd, ks),
                _yarn("weft", 30, 30, 0.5, 1.0, 2.0, 0.5, 0.5, kd, ks),
            ],
        )
    raise ValueError(f"unknown irawan preset '{name}'")


# --- the .cloth file grammar -------------------------------------------------

_NUM = r"[-+0-9.eE]+"


def _kv_pairs(body):
    """``key = value`` pairs of a block: numbers as floats, quoted and bare
    words as strings, ``{r, g, b}`` as float triples."""
    out = {}
    for mm in re.finditer(rf"(\w+)\s*=\s*({_NUM}|\"[^\"]*\"|\w+)", body):
        k, v = mm.group(1), mm.group(2)
        if v.startswith('"'):
            out[k] = v.strip('"')
        else:
            try:
                out[k] = float(v)
            except ValueError:
                out[k] = v
    for mm in re.finditer(rf"(\w+)\s*=\s*\{{\s*({_NUM})\s*,\s*({_NUM})"
                          rf"\s*,\s*({_NUM})\s*\}}", body):
        out[mm.group(1)] = (float(mm.group(2)), float(mm.group(3)),
                            float(mm.group(4)))
    return out


def load_cloth(path: str) -> dict:
    """The pattern dict of a reference ``.cloth`` file (irawan.h:340-395: a
    ``weave { ... }`` block of scalar fields, a ``pattern { ... }`` list of
    yarn ids and ``yarn { ... }`` blocks; angles in degrees)."""
    with open(path) as f:
        text = f.read()
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    pat_m = re.search(r"pattern\s*\{([^}]*)\}", text)
    if pat_m is None:
        raise ValueError(f"{path}: no pattern block")
    pattern = [int(float(x)) for x in re.findall(_NUM, pat_m.group(1))]
    yarns = []
    # a yarn block may end with a nested {r, g, b} (the grammar is
    # order-free), so its body takes one level of nested braces
    for ym in re.finditer(r"yarn\s*\{((?:[^{}]|\{[^{}]*\})*)\}",
                          text, flags=re.S):
        kv = _kv_pairs(ym.group(1))
        yarns.append(dict(
            type=0 if str(kv.get("type", "warp")) == "warp" else 1,
            psi=float(kv.get("psi", 0.0)) * DEG,
            umax=float(kv.get("umax", 30.0)) * DEG,
            kappa=float(kv.get("kappa", 0.0)),
            width=float(kv.get("width", 1.0)),
            length=float(kv.get("length", 2.0)),
            centerU=float(kv.get("centerU", 0.5)),
            centerV=float(kv.get("centerV", 0.5)),
            kd=kv.get("kd", (0.3, 0.3, 0.3)),
            ks=kv.get("ks", (0.4, 0.4, 0.4)),
        ))
    kv = _kv_pairs(text.split("pattern")[0])
    return dict(
        name=str(kv.get("name", "cloth")),
        tileWidth=int(float(kv.get("tileWidth", 2))),
        tileHeight=int(float(kv.get("tileHeight", 2))),
        alpha=float(kv.get("alpha", 0.05)),
        beta=float(kv.get("beta", 4.0)),
        ss=float(kv.get("ss", 0.5)),
        hWidth=float(kv.get("hWidth", 0.5)),
        warpArea=float(kv.get("warpArea", 0.5)),
        weftArea=float(kv.get("weftArea", 0.5)),
        fineness=float(kv.get("fineness", 0.0)),
        period=float(kv.get("period", 0.0)),
        dWarpUmaxOverDWarp=float(kv.get("dWarpUmaxOverDWarp", 0.0)) * DEG,
        dWarpUmaxOverDWeft=float(kv.get("dWarpUmaxOverDWeft", 0.0)) * DEG,
        dWeftUmaxOverDWarp=float(kv.get("dWeftUmaxOverDWarp", 0.0)) * DEG,
        dWeftUmaxOverDWeft=float(kv.get("dWeftUmaxOverDWeft", 0.0)) * DEG,
        pattern=pattern,
        yarns=yarns,
    )


# --- the table and the per-lane lookup ---------------------------------------

def build_table(patterns: list, repeats: list, device) -> IrawanTable:
    """The table of pattern dicts (``preset`` / ``load_cloth`` output) with
    their (repeatU, repeatV), on ``device``, with each pattern's specular
    normalization (computed on the CPU, so every device gets the same
    table)."""
    if not patterns:
        return IrawanTable.empty(device)
    tab = build_table_nonorm(patterns, repeats, device)
    norms = np.asarray([_specular_normalization(pd) for pd in patterns],
                       np.float32)
    return tab._replace(spec_norm=torch.as_tensor(norms, device=device))


def build_table_nonorm(patterns, repeats, device) -> IrawanTable:
    """The table with a unit normalization."""
    P = len(patterns)
    Hm = max(p["tileHeight"] for p in patterns)
    Wm = max(p["tileWidth"] for p in patterns)
    Ym = max(len(p["yarns"]) for p in patterns)
    pat = np.zeros((P, Hm, Wm), np.int32)
    yr = np.zeros((P, Ym, 8), np.float32)
    kd = np.zeros((P, Ym, 3), np.float32)
    ks = np.zeros((P, Ym, 3), np.float32)
    meta = np.zeros((P, 12), np.float32)
    for i, pd in enumerate(patterns):
        tw, th = pd["tileWidth"], pd["tileHeight"]
        pat[i, :th, :tw] = np.asarray(pd["pattern"], np.int32).reshape(
            th, tw) - 1
        for j, y in enumerate(pd["yarns"]):
            yr[i, j] = [y["type"], y["psi"], y["umax"], y["kappa"],
                        y["width"], y["length"], y["centerU"], y["centerV"]]
            kd[i, j] = y["kd"]
            ks[i, j] = y["ks"]
        meta[i] = [pd["alpha"], pd["beta"], pd["ss"], pd["hWidth"],
                   pd["warpArea"], pd["weftArea"],
                   pd.get("fineness", 0.0), pd.get("period", 0.0),
                   pd.get("dWarpUmaxOverDWarp", 0.0),
                   pd.get("dWarpUmaxOverDWeft", 0.0),
                   pd.get("dWeftUmaxOverDWarp", 0.0),
                   pd.get("dWeftUmaxOverDWeft", 0.0)]

    def t(x, dtype=np.float32):
        return torch.as_tensor(np.asarray(x, dtype), device=device)

    return IrawanTable(
        pattern=t(pat, np.int32),
        tile_w=t([p["tileWidth"] for p in patterns], np.int32),
        tile_h=t([p["tileHeight"] for p in patterns], np.int32),
        yarns=t(yr), yarn_kd=t(kd), yarn_ks=t(ks), meta=t(meta),
        repeat=t(np.asarray(repeats, np.float32).reshape(P, 2)),
        spec_norm=torch.ones(P, device=device),
    )


def _u32(x):
    """The JAX package's ``x.astype(int32).astype(uint32)`` of a float
    tensor: truncated toward 0, negative values wrapped modulo 2^32 (held
    in int64)."""
    return x.to(torch.int32).to(torch.int64) & 0xFFFFFFFF


def lane_params(tab: IrawanTable, pid, uv):
    """The yarn segment at each lane's ``uv`` in pattern ``pid`` (irawan.cpp
    eval:200-230): (iw_par (R, 13), iw_ks (R, 3), kd (R, 3)).

    iw_par: [is_weft, psi, umax, kappa, width, length, x, y, alpha, beta,
    ss, hwidth, specnorm * area_ratio]."""
    pid = torch.clamp(pid, min=0).to(torch.int64)
    rep = tab.repeat[pid]
    tw = tab.tile_w[pid].to(torch.float32)
    th = tab.tile_h[pid].to(torch.float32)
    u = uv[..., 0] * rep[..., 0]
    v = (1.0 - uv[..., 1]) * rep[..., 1]
    x = u * tw
    y = v * th
    # a floored modulo (jnp.mod), exact on these integer values
    lx = torch.remainder(torch.floor(x), tw).to(torch.int32).to(torch.int64)
    ly = torch.remainder(torch.floor(y), th).to(torch.int32).to(torch.int64)
    yid = tab.pattern[pid, ly, lx].to(torch.int64)
    yarn = tab.yarns[pid, yid]                     # (R, 8)
    center_x = torch.floor(x / tw) * tw + yarn[..., 6] * tw
    center_y = torch.floor(y / th) * th + (1.0 - yarn[..., 7]) * th
    xx = x - center_x
    yy = -(y - center_y)
    mt = tab.meta[pid]                             # (R, 12)
    is_weft = yarn[..., 0] > 0.5
    area = torch.where(is_weft, mt[..., 5], mt[..., 4])
    area_ratio = m.safe_div(mt[..., 4] + mt[..., 5], area)
    snorm = tab.spec_norm[pid] * area_ratio

    # the correlated yarn-tension noise (irawan.cpp:255-275): where period
    # > 0, each segment perturbs its umax by 1-D Perlin noise seeded per
    # segment (the JAX package's PCG4D jitter in place of the reference's
    # TEA hash)
    umax = yarn[..., 2]
    period = mt[..., 7]
    has_period = period > 0.0
    psafe = torch.where(has_period, period, 1.0)
    cxu = _u32(center_x)
    cyu = _u32(center_y)
    j1 = _hash01(cxu, 2 * cyu)
    j2 = _hash01(cxu, 2 * cyu + 1)
    rep_v = th * rep[..., 1]
    rep_u = tw * rep[..., 0]
    t1 = (center_x * (rep_v + j1) + center_y) / psafe
    t2 = (center_y * (rep_u + j2) + center_x) / psafe
    z = torch.zeros_like(t1)
    r1 = noise_mod.perlin_3d(torch.stack([t1, z, z], dim=-1))
    r2 = noise_mod.perlin_3d(torch.stack([t2, z, z], dim=-1))
    dU_warp = torch.where(is_weft, mt[..., 10], mt[..., 8])
    dU_weft = torch.where(is_weft, mt[..., 11], mt[..., 9])
    umax = torch.where(has_period, umax + r1 * dU_warp + r2 * dU_weft, umax)

    # the specular intensity variation (irawan.cpp:293-302): fineness^2
    # seeds per texture unit scale the specular term by min(-log xi, 10);
    # it does not depend on the directions, so it folds into the snorm
    # column, indexed in the segment's rotated frame as eval indexes it
    fineness = mt[..., 6]
    xr = torch.where(is_weft, -yy, xx)
    yr2 = torch.where(is_weft, xx, yy)
    i1 = _u32((center_x + xr) * fineness)
    i2 = _u32((center_y + yr2) * fineness)
    xi = torch.clamp(_hash01(i1, i2), min=1e-9)
    ivar = torch.clamp(-torch.log(xi), max=10.0)
    snorm = torch.where(fineness > 0.0, snorm * ivar, snorm)

    iw_par = torch.stack([
        yarn[..., 0], yarn[..., 1], umax, yarn[..., 3],
        yarn[..., 4], yarn[..., 5], xx, yy,
        mt[..., 0], mt[..., 1], mt[..., 2], mt[..., 3], snorm,
    ], dim=-1)
    return iw_par, tab.yarn_ks[pid, yid], tab.yarn_kd[pid, yid]


def _hash01(a, b):
    """A [0, 1) float from two uint32 indices (int64 tensors): the PCG4D
    mix of (a, b, two constants), in the sampleTEAFloat role of
    qmc.h:146-217."""
    v = torch.stack([a, b, torch.full_like(a, 0x9E3779B9),
                     torch.full_like(a, 0x85EBCA6B)], dim=-1)
    return rng_mod._to_unit_float(rng_mod.pcg4d(v)[..., 0])


def _specular_normalization(pd: dict, n: int = 10000, seed: int = 5) -> float:
    """IrawanClothBRDF::configure() (irawan.cpp:138-171): the mean of the
    raw specular integrand over cosine-distributed wi and wo and uniform
    uv, so that the specular reflectance under diffuse light peaks at
    1 / pi. The draws are numpy's ``default_rng(seed)``, as in the JAX
    package; the sum runs on the CPU."""
    tab = build_table_nonorm([pd], [(1.0, 1.0)], "cpu")
    rng = np.random.default_rng(seed)
    wi = warp.square_to_cosine_hemisphere(
        torch.from_numpy(rng.random((n, 2), np.float32)))
    wo = warp.square_to_cosine_hemisphere(
        torch.from_numpy(rng.random((n, 2), np.float32)))
    uvs = torch.from_numpy(rng.random((n, 2), np.float32))
    # the unit table's snorm column is exactly the warp / weft area ratio,
    # which the reference includes in its sum (irawan.cpp:305-312 in
    # initialization mode)
    iw_par, _, _ = lane_params(tab, torch.zeros(n, dtype=torch.int64), uvs)
    f = bsdf_mod._irawan_eval(_norm_locals(n, iw_par), wi, wo)
    cos_o = np.maximum(wo.numpy()[..., 2], 1e-6)
    total = float((f[..., 0].numpy() / cos_o).sum())
    if total <= 0:
        return 0.0
    return n / (total * np.pi)


def _norm_locals(n, iw_par):
    """BsdfLocals of n IRAWAN lanes with yarn parameters ``iw_par``, a zero
    kd and a unit ks (the normalization's integrand)."""
    dev = iw_par.device
    z3 = torch.zeros((n, 3), device=dev)
    return bsdf_mod.BsdfLocals(
        type=torch.full((n,), bsdf_mod.IRAWAN, dtype=torch.int32, device=dev),
        dist=torch.zeros(n, dtype=torch.int32, device=dev), albedo=z3,
        spec_refl=torch.ones((n, 3), device=dev),
        eta_c=torch.ones((n, 3), device=dev), k_c=z3,
        alpha=torch.full((n, 2), 0.1, device=dev),
        twosided=torch.zeros(n, dtype=torch.bool, device=dev),
        iw_par=iw_par, iw_ks=torch.ones((n, 3), device=dev))
