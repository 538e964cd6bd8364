"""Mitsuba 0.6 XML scene loader (port of ``mitsuba_tpu/io/mitsuba_xml.py``).

The reference's SceneHandler pipeline (scenehandler.cpp): the XML scene
description becomes Properties-like dicts which instantiate builder-side
objects by type name, with ``$key`` substitution of ``-D key=value`` defines
(mitsuba.cpp) and ``<default>`` / ``<include>`` elements.

The loader copies the JAX loader's dispatch, element for element. Each
element falls in one of three cases:

1. The port renders it: the same ``SceneBuilder`` calls as the JAX loader's,
   in the same order and with the same arguments, so material, mesh and
   emitter ids come out equal.
2. The JAX loader ignores it with a warning (an unknown element, shape or
   emitter type; an unknown BSDF at the top level): the port does the same.
3. The JAX package renders it but the port does not yet: the port raises
   ``NotImplementedError`` naming the ``ROADMAP.md`` item where it lands.
   Nothing is approximated in its place.
"""
from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..core.spectrum import spd_to_rgb
from ..core.transform import Transform
from ..device import resolve_device
from ..render import api as api_mod
from ..render import bsdf as B
from ..render import microfacet as mf
from ..render import phase as PH
from ..render import rfilter as RF
from ..render import sensor as sensor_mod
from ..render import shapes as shapes_mod
from ..render import sunsky as sunsky_mod
from ..render.integrators import common as icommon
from ..render.scene import SceneBuilder
from ..utils.logging import get_logger
from .mesh import load_mesh, load_obj
from .volgrid import load_vol

log = get_logger()

# Conductor IOR presets resampled to sRGB (public Palik / CRC handbook data;
# the reference ships full spectra in data/ior/*.spd)
CONDUCTOR_IOR = {
    "au": ((0.143, 0.375, 1.442), (3.983, 2.386, 1.603)),
    "ag": ((0.155, 0.116, 0.138), (4.820, 3.120, 2.140)),
    "cu": ((0.200, 0.924, 1.102), (3.910, 2.447, 2.137)),
    "al": ((1.345, 0.965, 0.617), (7.474, 6.400, 5.303)),
    "cr": ((3.210, 3.170, 2.440), (3.300, 3.330, 3.210)),
    "ni": ((2.010, 1.850, 1.650), (3.750, 3.480, 3.100)),
    "none": ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),  # idealized mirror
}

# dielectric IOR names (dielectric.cpp table)
DIELECTRIC_IOR = {
    "vacuum": 1.0, "helium": 1.000036, "hydrogen": 1.000132,
    "air": 1.000277, "carbon dioxide": 1.00045, "water": 1.3330,
    "acetone": 1.36, "ethanol": 1.361, "carbon tetrachloride": 1.461,
    "glycerol": 1.4729, "benzene": 1.501, "silicone oil": 1.52045,
    "bromine": 1.661, "water ice": 1.31, "fused quartz": 1.458,
    "pyrex": 1.470, "acrylic glass": 1.49, "polypropylene": 1.49,
    "bk7": 1.5046, "sodium chloride": 1.544, "amber": 1.55,
    "pet": 1.5750, "diamond": 2.419,
}

# the elements of case 3, by the JAX loader's type name, with the ROADMAP.md
# item (Queue 1) where each lands
_LATER_INTEGRATORS = {
    "vpl": "3.11", "sppm": "3.11", "ppm": "3.11", "photonmapper": "3.11",
    "irrcache": "3.11", "adaptive": "3.12",
}
_INTEGRATORS = {"path": icommon.PATH, "volpath": icommon.VOLPATH,
                "volpath_simple": icommon.VOLPATH, "direct": icommon.DIRECT,
                "ao": icommon.AO, "field": icommon.FIELD,
                "ptracer": icommon.PTRACER, "bdpt": icommon.BDPT,
                "pssmlt": icommon.PSSMLT, "mlt": icommon.MLT,
                "erpt": icommon.ERPT}
# the phase functions a scene file names (the JAX loader's three; any other
# name is isotropic there too)
_PHASES = {"isotropic": PH.ISOTROPIC, "hg": PH.HG, "rayleigh": PH.RAYLEIGH}
_SAMPLERS = {
    "independent": api_mod.INDEPENDENT, "stratified": api_mod.STRATIFIED,
    "ldsampler": api_mod.LDSAMPLER, "sobol": api_mod.SOBOL,
    "halton": api_mod.HALTON, "hammersley": api_mod.HAMMERSLEY,
    "faure": api_mod.FAURE,
}
_RFILTERS = {
    "box": RF.BOX, "tent": RF.TENT, "gaussian": RF.GAUSSIAN,
    "mitchell": RF.MITCHELL, "catmullrom": RF.CATMULLROM,
    "lanczos": RF.LANCZOS,
}
_LATER_SENSORS = {}  # every sensor element loads since item 3.3
_LATER_BSDFS = {}  # every BSDF element loads since item 3.2.4
_LATER_EMITTERS = {}  # every emitter element loads since item 3.8
_METERS = ("radiancemeter", "irradiancemeter", "fluencemeter")


def _rgb(v) -> np.ndarray:
    """A property's value as three float64 channels (a scalar repeated)."""
    return np.broadcast_to(np.asarray(v, np.float64), (3,))


def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} lands in a later slice of the port (ROADMAP.md, Queue 1 "
        f"item {item})")


@dataclass
class LoadedScene:
    scene: object
    static: object
    sensor: object
    integrator: icommon.IntegratorConfig
    settings: api_mod.RenderSettings
    ids: dict = field(default_factory=dict)


def _subst(text: str, params: dict) -> str:
    if text and "$" in text:
        for k, v in params.items():
            text = text.replace(f"${k}", str(v))
    return text


def _props(node, params) -> dict:
    """Collect child value tags into a Properties-style dict."""
    out = {}
    for c in node:
        tag = c.tag
        name = _subst(c.get("name", ""), params)
        val = _subst(c.get("value", ""), params)
        if tag == "float":
            out[name] = float(val)
        elif tag == "integer":
            out[name] = int(val)
        elif tag == "boolean":
            out[name] = val.lower() == "true"
        elif tag == "string":
            out[name] = val
        elif tag in ("rgb", "srgb", "spectrum"):
            out[name] = _parse_spectrum(tag, val)
        elif tag == "vector" or tag == "point":
            out[name] = _parse_vec(c, params)
        elif tag == "transform":
            out[name] = _parse_transform(c, params)
    return out


def _parse_spectrum(tag, val):
    val = val.strip()
    if "," in val or " " in val:
        parts = [p for p in re.split(r"[,\s]+", val) if p]
        if all(":" in p for p in parts):
            # wavelength:value pairs, resampled to RGB
            wl = [float(p.split(":")[0]) for p in parts]
            vv = [float(p.split(":")[1]) for p in parts]
            return tuple(np.maximum(spd_to_rgb(wl, vv), 0.0))
        vals = [float(p) for p in parts]
        if len(vals) == 3:
            return tuple(vals)
        return (float(np.mean(vals)),) * 3
    v = float(val)
    return (v, v, v)


def _floats(text, params):
    return [float(x) for x in re.split(r"[,\s]+", _subst(text, params)) if x]


def _parse_vec(c, params):
    if c.get("value"):
        return tuple(_floats(c.get("value"), params))
    return (
        float(_subst(c.get("x", "0"), params)),
        float(_subst(c.get("y", "0"), params)),
        float(_subst(c.get("z", "0"), params)),
    )


def _parse_transform(node, params) -> Transform:
    t = Transform.identity()
    for c in node:
        if c.tag == "translate":
            t = Transform.translate(_parse_vec(c, params)) * t
        elif c.tag == "scale":
            if c.get("value") is not None:
                parts = _floats(c.get("value"), params)
                s = parts if len(parts) == 3 else [parts[0]] * 3
            else:
                s = [float(_subst(c.get(k, "1"), params)) for k in "xyz"]
            t = Transform.scale(s) * t
        elif c.tag == "rotate":
            axis = _parse_vec(c, params)
            angle = float(_subst(c.get("angle", "0"), params))
            t = Transform.rotate(axis, angle) * t
        elif c.tag == "matrix":
            vals = [float(x) for x in _subst(c.get("value"), params).split()]
            if len(vals) == 16:
                t = Transform.from_matrix(np.asarray(vals).reshape(4, 4)) * t
            elif len(vals) == 9:
                mat = np.eye(4)
                mat[:3, :3] = np.asarray(vals).reshape(3, 3)
                t = Transform.from_matrix(mat) * t
        elif c.tag == "lookat":
            origin = _floats(c.get("origin"), params)
            target = _floats(c.get("target"), params)
            up_s = c.get("up")
            up = _floats(up_s, params) if up_s else [0, 1, 0]
            t = Transform.look_at(origin, target, up) * t
    return t


class XMLSceneLoader:
    def __init__(self, path: str, defines: Optional[dict] = None,
                 device=None):
        self.device = resolve_device(device)
        self.dir = os.path.dirname(os.path.abspath(path))
        self.params = dict(defines or {})
        self.builder = SceneBuilder()
        self.ids: dict = {}
        self.integrator = icommon.IntegratorConfig()
        self.sensor = None
        self.width, self.height, self.spp = 256, 256, 16
        self.filter_type = RF.GAUSSIAN
        self.sampler_type = api_mod.INDEPENDENT
        self.tree = ET.parse(path)

    def resolve_path(self, p: str) -> str:
        if os.path.isabs(p):
            return p
        return os.path.join(self.dir, p)

    def load(self) -> LoadedScene:
        root = self.tree.getroot()
        if root.tag != "scene":
            raise ValueError("root element must be <scene>")
        self._load_children(root)
        scene, static = self.builder.build(device=self.device)
        settings = api_mod.RenderSettings(
            width=self.width, height=self.height, spp=self.spp,
            filter_type=self.filter_type, sampler_type=self.sampler_type,
            spp_per_pass=min(4, self.spp),
        )
        if self.sensor is None:
            self.sensor = sensor_mod.make_perspective(
                Transform.look_at([0, 0, -1], [0, 0, 0], [0, 1, 0]),
                45.0, self.width, self.height, device=self.device,
            )
        return LoadedScene(
            scene=scene, static=static, sensor=self.sensor,
            integrator=self.integrator, settings=settings, ids=self.ids,
        )

    def _load_children(self, root) -> None:
        """Dispatch a <scene> element's children; <include> recurses into
        another scene file's children in place (scene.cpp)."""
        for c in root.findall("default"):
            self.params.setdefault(c.get("name"), c.get("value"))
        for c in root:
            if c.tag == "integrator":
                self._load_integrator(c)
            elif c.tag == "sensor":
                self._load_sensor(c)
            elif c.tag == "bsdf":
                try:
                    mat_id = self._load_bsdf(c)
                except ValueError as e:
                    log.warning(f"scene: skipping bsdf: {e}")
                    continue
                if c.get("id"):
                    self.ids[c.get("id")] = ("bsdf", mat_id)
            elif c.tag == "texture":
                tex_id = self._load_texture(c)
                if c.get("id"):
                    self.ids[c.get("id")] = ("texture", tex_id)
            elif c.tag == "shape":
                self._load_shape(c)
            elif c.tag == "emitter":
                self._load_emitter(c)
            elif c.tag == "medium":
                mid = self._load_medium(c)
                if c.get("id"):
                    self.ids[c.get("id")] = ("medium", mid)
            elif c.tag == "include":
                sub = ET.parse(self.resolve_path(
                    _subst(c.get("filename"), self.params)))
                sroot = sub.getroot()
                if sroot.tag != "scene":
                    raise ValueError("included root must be <scene>")
                self._load_children(sroot)
            elif c.tag in ("default", "alias", "null", "phase"):
                # a top-level phase function builds nothing in the JAX
                # loader either (it feeds its chi-square harness)
                pass
            elif isinstance(c.tag, str):
                log.warning(f"scene: ignoring unsupported element <{c.tag}>")

    # --- sections ---------------------------------------------------------

    def _load_integrator(self, node):
        t = node.get("type")
        p = _props(node, self.params)
        if t in _LATER_INTEGRATORS:
            raise _later(f"the {t} integrator", _LATER_INTEGRATORS[t])
        if t == "multichannel":
            # multichannel.cpp wraps nested integrators: the JAX loader
            # adopts the first one (api.render_multichannel stacks several)
            nested = node.find("integrator")
            if nested is None:
                raise ValueError("the multichannel integrator needs a "
                                 "nested integrator")
            self._load_integrator(nested)
            return
        if t not in _INTEGRATORS:
            raise ValueError(f"unsupported integrator type '{t}'")
        self.integrator = icommon.IntegratorConfig(
            type=_INTEGRATORS[t],
            max_depth=int(p.get("maxDepth", -1)),
            rr_depth=int(p.get("rrDepth", 5)),
            hide_emitters=bool(p.get("hideEmitters", False)),
            emitter_samples=int(p.get("emitterSamples", 1)),
            bsdf_samples=int(p.get("bsdfSamples", 1)),
            ray_length=float(p.get("rayLength", -1.0)),
            shading_samples=int(p.get("shadingSamples", 1)),
            # the Metropolis family's (the JAX loader reads no chain count)
            p_large=float(p.get("pLarge", 0.3)),
            luminance_samples=int(p.get("luminanceSamples", 65536)),
            chain_length=int(p.get("chainLength", 64)),
        )

    def _load_sensor(self, node):
        t = node.get("type")
        p = _props(node, self.params)
        if t in _LATER_SENSORS:
            raise _later(f"the {t} sensor", _LATER_SENSORS[t])
        film = node.find("film")
        is_meter = t in _METERS
        if film is not None:
            fp = _props(film, self.params)
            # a meter's film and mfilm default to a 1x1 numeric matrix
            # (mfilm.cpp, irradiancemeter.cpp)
            dw, dh = ((1, 1) if is_meter or film.get("type") == "mfilm"
                      else (768, 576))
            self.width = int(fp.get("width", dw))
            self.height = int(fp.get("height", dh))
        elif is_meter:
            self.width = self.height = 1
        if film is not None:
            rf = film.find("rfilter")
            if rf is not None:
                self.filter_type = _RFILTERS.get(rf.get("type"), RF.GAUSSIAN)
        samp = node.find("sampler")
        if samp is not None:
            sp = _props(samp, self.params)
            self.spp = int(sp.get("sampleCount", 16))
            self.sampler_type = _SAMPLERS.get(samp.get("type"),
                                              api_mod.INDEPENDENT)
        to_world = p.get("toWorld", Transform.identity())
        fov = float(p.get("fov", 45.0))
        fov_axis = p.get("fovAxis", "x")
        dev = self.device
        if t == "perspective":
            self.sensor = sensor_mod.make_perspective(
                to_world, fov, self.width, self.height, fov_axis=fov_axis,
                device=dev)
        elif t == "thinlens":
            self.sensor = sensor_mod.make_thinlens(
                to_world, fov, self.width, self.height,
                float(p.get("apertureRadius", 0.0)),
                float(p.get("focusDistance", 1.0)), fov_axis=fov_axis,
                device=dev)
        elif t == "orthographic":
            self.sensor = sensor_mod.make_orthographic(
                to_world, self.width, self.height, device=dev)
        elif t == "spherical":
            self.sensor = sensor_mod.make_spherical(to_world, device=dev)
        elif t in _METERS:
            # at the transform's origin, along its +z
            self.sensor = self._meter(t, to_world.apply_point([0, 0, 0]),
                                      to_world.apply_vector([0, 0, 1]))
        else:
            log.warning(f"scene: unsupported sensor type '{t}', "
                        "falling back to perspective")

    def _texture_ref_or_value(self, node, p, pname, default):
        """A parameter that is either a spectrum value or a nested or
        referenced texture. Returns (value_rgb, tex_id)."""
        for c in node.findall("texture"):
            if c.get("name") == pname:
                return default, self._load_texture(c)
        for c in node.findall("ref"):
            if c.get("name") == pname:
                kind, idx = self.ids[c.get("id")]
                if kind != "texture":
                    raise ValueError(f"'{c.get('id')}' is a {kind}, not a "
                                     "texture")
                return default, idx
        if pname in p:
            return p[pname], -1
        return default, -1

    def _load_texture(self, node) -> int:
        t = node.get("type")
        p = _props(node, self.params)
        uv_scale = (float(p.get("uscale", 1.0)), float(p.get("vscale", 1.0)))
        uv_off = (float(p.get("uoffset", 0.0)), float(p.get("voffset", 0.0)))
        if t == "checkerboard":
            return self.builder.add_texture_checkerboard(
                color0=p.get("color0", (0.4,) * 3),
                color1=p.get("color1", (0.2,) * 3),
                uv_scale=uv_scale, uv_offset=uv_off)
        if t == "gridtexture":
            return self.builder.add_texture_grid(
                color0=p.get("color0", (0.2,) * 3),
                color1=p.get("color1", (0.4,) * 3),
                line_width=float(p.get("lineWidth", 0.01)),
                uv_scale=uv_scale, uv_offset=uv_off)
        if t == "bitmap":
            img = _load_image(self.resolve_path(p["filename"]))
            return self.builder.add_texture_bitmap(img, uv_scale=uv_scale,
                                                   uv_offset=uv_off)
        if t == "scale":
            # scale.cpp: the multiplier folds into the nested texture's own
            # row (the JAX loader's; the builder's add_texture_scale copies
            # the row instead), or scales a constant value
            sc = p.get("scale", (1.0,) * 3)
            if np.isscalar(sc):
                sc = (float(sc),) * 3
            inner = node.find("texture")
            if inner is not None:
                tid = self._load_texture(inner)
                rec = self.builder.textures[tid]
                rec["scale"] = tuple(np.asarray(rec["scale"]) * np.asarray(sc))
                return tid
            val = p.get("value", (1.0,) * 3)
            return self.builder.add_texture_constant(
                tuple(np.asarray(val) * np.asarray(sc)))
        raise ValueError(f"unsupported texture type '{t}'")

    def _load_bsdf(self, node, twosided=False) -> int:
        t = node.get("type")
        p = _props(node, self.params)
        if t == "twosided":
            return self._load_bsdf(node.find("bsdf"), twosided=True)
        if t in _LATER_BSDFS:
            raise _later(f"the {t} BSDF", _LATER_BSDFS[t])
        if t == "mask":
            # mask.cpp: an opacity texture (a constant one for a value) over
            # a nested BSDF, which keeps the twosided flag
            mid = self._load_bsdf(node.find("bsdf"), twosided=twosided)
            op, op_tex = self._texture_ref_or_value(node, p, "opacity",
                                                    (0.5,) * 3)
            if op_tex < 0:
                op_tex = self.builder.add_texture_constant(tuple(
                    np.broadcast_to(np.asarray(op, np.float64), (3,))))
            return self.builder.add_material(type=B.MASK, nested_a=mid,
                                             opacity_tex=op_tex)

        def ior_of(key, default):
            v = p.get(key, default)
            if isinstance(v, str):
                return DIELECTRIC_IOR[v.lower()]
            if isinstance(v, tuple):
                return float(v[0])
            return float(v)

        # phong / Ashikhmin-Shirley microfacet distributions map to Beckmann
        # in the JAX loader
        dist = {"beckmann": mf.BECKMANN, "ggx": mf.GGX, "phong": mf.BECKMANN,
                "as": mf.BECKMANN}[p.get("distribution", "beckmann")]
        alpha = p.get("alpha", 0.1)
        if isinstance(alpha, tuple):
            alpha = alpha[0]
        alpha_u = float(p.get("alphaU", alpha))
        alpha_v = float(p.get("alphaV", alpha))

        if t == "diffuse":
            refl, tex = self._texture_ref_or_value(node, p, "reflectance",
                                                   (0.5,) * 3)
            return self.builder.add_material(type=B.DIFFUSE, albedo=refl,
                                             albedo_tex=tex, twosided=twosided)
        if t == "roughdiffuse":
            refl, tex = self._texture_ref_or_value(node, p, "reflectance",
                                                   (0.5,) * 3)
            a = p.get("alpha", 0.2)
            if isinstance(a, tuple):
                a = a[0]
            return self.builder.add_material(
                type=B.ROUGH_DIFFUSE, albedo=refl, albedo_tex=tex,
                alpha=(float(a),) * 2, twosided=twosided)
        if t in ("dielectric", "thindielectric", "roughdielectric"):
            int_ior = ior_of("intIOR", "bk7")
            ext_ior = ior_of("extIOR", "air")
            ty = {"dielectric": B.DIELECTRIC,
                  "thindielectric": B.THIN_DIELECTRIC,
                  "roughdielectric": B.ROUGH_DIELECTRIC}[t]
            return self.builder.add_material(
                type=ty, eta=int_ior / ext_ior,
                spec_refl=p.get("specularReflectance", (1.0,) * 3),
                spec_trans=p.get("specularTransmittance", (1.0,) * 3),
                alpha=(alpha_u, alpha_v), dist=dist,
            )
        if t in ("conductor", "roughconductor"):
            eta, k = CONDUCTOR_IOR.get(p.get("material", "cu").lower(),
                                       CONDUCTOR_IOR["cu"])
            return self.builder.add_material(
                type=B.CONDUCTOR if t == "conductor" else B.ROUGH_CONDUCTOR,
                eta=p.get("eta", eta), k=p.get("k", k),
                spec_refl=p.get("specularReflectance", (1.0,) * 3),
                alpha=(alpha_u, alpha_v), dist=dist, twosided=twosided,
            )
        if t in ("plastic", "roughplastic"):
            refl, tex = self._texture_ref_or_value(node, p, "diffuseReflectance",
                                                   (0.5,) * 3)
            return self.builder.add_material(
                type=B.PLASTIC if t == "plastic" else B.ROUGH_PLASTIC,
                albedo=refl, albedo_tex=tex,
                eta=ior_of("intIOR", "polypropylene") / ior_of("extIOR", "air"),
                spec_refl=p.get("specularReflectance", (1.0,) * 3),
                alpha=(alpha_u, alpha_v), dist=dist,
                nonlinear=bool(p.get("nonlinear", False)), twosided=twosided,
            )
        if t == "phong":
            refl, tex = self._texture_ref_or_value(node, p, "diffuseReflectance",
                                                   (0.5,) * 3)
            # the exponent n is stored as alpha = sqrt(2 / (n + 2))
            a = float(np.sqrt(2.0 / (float(p.get("exponent", 30.0)) + 2.0)))
            return self.builder.add_material(
                type=B.PHONG, albedo=refl, albedo_tex=tex,
                spec_refl=p.get("specularReflectance", (0.2,) * 3),
                alpha=(a, a), twosided=twosided)
        if t == "ward":
            refl, tex = self._texture_ref_or_value(node, p, "diffuseReflectance",
                                                   (0.5,) * 3)
            return self.builder.add_material(
                type=B.WARD, albedo=refl, albedo_tex=tex,
                spec_refl=p.get("specularReflectance", (0.2,) * 3),
                alpha=(alpha_u, alpha_v), twosided=twosided)
        if t == "difftrans":
            # the lobe reads spec_trans; a textured transmittance has no
            # column it reads yet (the JAX loader puts the transmittance in
            # the albedo column, which the lobe never reads)
            trans, tex = self._texture_ref_or_value(node, p, "transmittance",
                                                    (0.5,) * 3)
            if tex >= 0:
                raise _later("a textured difftrans transmittance", "3.2.3")
            return self.builder.add_material(
                type=B.DIFFTRANS, spec_trans=tuple(
                    np.broadcast_to(np.asarray(trans, np.float64), (3,))))
        if t == "hk":
            ss = np.broadcast_to(
                np.asarray(p.get("sigmaS", (1.0,) * 3), np.float64), (3,))
            sa = np.broadcast_to(
                np.asarray(p.get("sigmaA", (0.05,) * 3), np.float64), (3,))
            g = 0.0
            ph = node.find("phase")
            if ph is not None and ph.get("type") == "hg":
                g = float(_props(ph, self.params).get("g", 0.0))
            # sigma_s in the albedo column, sigma_t in k
            return self.builder.add_material(
                type=B.HK, albedo=tuple(ss), k=tuple(ss + sa),
                hk_thickness=float(p.get("thickness", 1.0)), hk_g=g)
        if t == "irawan":
            # woven cloth (irawan.cpp): a .cloth pattern file, resolved
            # relative to the scene, or else a built-in preset
            fn = str(p.get("filename", ""))
            if fn:
                fn = self.resolve_path(fn)
            pid = self.builder.add_irawan_pattern(
                preset=str(p.get("preset", "plain")), filename=fn,
                kd=tuple(np.broadcast_to(
                    np.asarray(p.get("kd", (0.3,) * 3), np.float64), (3,))),
                ks=tuple(np.broadcast_to(
                    np.asarray(p.get("ks", (0.4,) * 3), np.float64), (3,))),
                repeat_u=float(p.get("repeatU", 10.0)),
                repeat_v=float(p.get("repeatV", 10.0)))
            return self.builder.add_material(type=B.IRAWAN, irawan=pid)
        if t == "mixturebsdf":
            return self._load_mixture(node, p)
        if t == "blendbsdf":
            # blendbsdf.cpp's weight is the second BSDF's: nested A is the
            # second child; a constant weight makes a MIXTURE row
            mids = [self._load_bsdf(c) for c in node.findall("bsdf")]
            _, wtex = self._texture_ref_or_value(node, p, "weight", (0.5,) * 3)
            if wtex < 0:
                w = p.get("weight", 0.5)
                w = float(w[0]) if isinstance(w, tuple) else float(w)
                return self.builder.add_material(
                    type=B.MIXTURE, nested_a=mids[1], nested_b=mids[0],
                    weight=w)
            return self.builder.add_material(
                type=B.BLEND, nested_a=mids[1], nested_b=mids[0],
                weight_tex=wtex)
        if t in ("coating", "roughcoating"):
            inner = node.find("bsdf")
            if inner is None:
                refs = [c for c in node.findall("ref") if c.get("name") is None]
                mid = (self.ids[refs[0].get("id")][1] if refs
                       else self.builder.add_material())
            else:
                mid = self._load_bsdf(inner)
            sa = np.broadcast_to(
                np.asarray(p.get("sigmaA", (0.0,) * 3), np.float64), (3,))
            th = float(p.get("thickness", 1.0))
            eta_rel = ior_of("intIOR", "bk7") / ior_of("extIOR", "air")
            # the k column holds sigma_a * thickness
            if t == "roughcoating":
                a = p.get("alpha", 0.1)
                a = float(a[0] if isinstance(a, tuple) else a)
                return self.builder.add_material(
                    type=B.ROUGHCOATING, nested_a=mid, eta=(eta_rel,) * 3,
                    alpha=(a, a), dist=dist, k=tuple(sa * th))
            return self.builder.add_material(
                type=B.COATING, nested_a=mid, eta=eta_rel, k=tuple(sa * th))
        if t in ("normalmap", "bumpmap"):
            # a copy of the nested BSDF's row that carries the map (the
            # first <texture> child); without one, the nested row itself
            mid = self._load_bsdf(node.find("bsdf"), twosided=twosided)
            for c in node.findall("texture"):
                tex = self._load_texture(c)
                rec = dict(self.builder.mats[mid])
                if t == "normalmap":
                    rec["normal_tex"] = tex
                else:
                    rec["bump_tex"] = tex
                    rec["bump_scale"] = float(p.get("scale", 1.0))
                self.builder.mats.append(rec)
                return len(self.builder.mats) - 1
            return mid
        if t == "null":
            return self.builder.add_material(type=B.NULL)
        raise ValueError(f"unsupported bsdf type '{t}'")

    def _load_mixture(self, node, p) -> int:
        """mixturebsdf.cpp with two lobes: the weights renormalised to sum
        to 1 (with a warning otherwise); any other count keeps the first
        lobe alone, with a warning."""
        ws = [float(x) for x in str(p.get("weights", "0.5 0.5")).split()]
        mids = [self._load_bsdf(c) for c in node.findall("bsdf")]
        mids += [self.ids[c.get("id")][1] for c in node.findall("ref")
                 if c.get("name") is None]
        if len(mids) != 2 or len(ws) != len(mids):
            log.warning("scene: mixturebsdf supports exactly 2 lobes; "
                        f"got {len(mids)} — using the first")
            return mids[0] if mids else self.builder.add_material()
        tot = ws[0] + ws[1]
        if abs(tot - 1.0) > 1e-6:
            log.warning(f"scene: mixturebsdf weights sum to {tot:g}; "
                        "renormalizing")
        return self.builder.add_material(
            type=B.MIXTURE, nested_a=mids[0], nested_b=mids[1],
            weight=ws[0] / max(tot, 1e-9))

    def _load_medium(self, node) -> int:
        """<medium type="homogeneous|heterogeneous"> with a nested <phase>
        (isotropic, hg, rayleigh). A homogeneous medium takes sigmaT and
        albedo, or else sigmaS and sigmaA; a heterogeneous one a gridvolume
        .vol file (resolved relative to the scene) or a constvolume as its
        density; both take a scale."""
        t = node.get("type")
        p = _props(node, self.params)
        ph_type, ph_g = PH.ISOTROPIC, 0.0
        ph = node.find("phase")
        if ph is not None:
            ph_type = _PHASES.get(ph.get("type"), PH.ISOTROPIC)
            ph_g = float(_props(ph, self.params).get("g", 0.0))
        scale = float(p.get("scale", 1.0))
        if t == "homogeneous":
            if "sigmaT" in p or "albedo" in p:
                st = _rgb(p.get("sigmaT", 1.0))
                ss = st * _rgb(p.get("albedo", 0.5))
                sa = st - ss
            else:
                ss = _rgb(p.get("sigmaS", 1.0))
                sa = _rgb(p.get("sigmaA", 0.5))
            return self.builder.add_medium_homogeneous(
                sigma_s=tuple(ss), sigma_a=tuple(sa), phase_type=ph_type,
                phase_g=ph_g, scale=scale)
        if t == "heterogeneous":
            vol, w2g = None, np.eye(4)
            for c in node.findall("volume"):
                if c.get("name") in ("density", None):
                    vp = _props(c, self.params)
                    if c.get("type") == "gridvolume":
                        vol, w2g = load_vol(self.resolve_path(vp["filename"]))
                    elif c.get("type") == "constvolume":
                        vol = np.full((2, 2, 2), float(np.mean(
                            vp.get("value", 1.0))), np.float32)
                        w2g = np.eye(4)
            if vol is None:
                vol = np.ones((2, 2, 2), np.float32)
            return self.builder.add_medium_heterogeneous(
                vol, sigma_t=tuple(_rgb(p.get("sigmaT", 1.0))),
                albedo=tuple(_rgb(p.get("albedo", 0.8))),
                phase_type=ph_type, phase_g=ph_g, scale=scale,
                world_to_grid=w2g)
        raise ValueError(f"unsupported medium type '{t}'")

    def _shape_medium(self, node, which: str) -> int:
        """A shape's nested or referenced ``which`` ("interior" or
        "exterior") medium; a nested medium without a name is the
        interior. -1 for none."""
        for c in node.findall("medium"):
            if c.get("name") == which or (which == "interior"
                                          and c.get("name") is None):
                mid = self._load_medium(c)
                if c.get("id"):
                    self.ids[c.get("id")] = ("medium", mid)
                return mid
        for c in node.findall("ref"):
            if c.get("name") == which:
                kind, idx = self.ids[c.get("id")]
                if kind == "medium":
                    return idx
        return -1

    def _shape_material(self, node, interior_medium: int = -1,
                        exterior_medium: int = -1) -> int:
        mat_id = None
        for c in node.findall("ref"):
            if c.get("name") in (None, "bsdf"):
                kind, idx = self.ids[c.get("id")]
                if kind == "bsdf":
                    mat_id = idx
        if mat_id is None:
            inner = node.find("bsdf")
            if inner is not None:
                mat_id = self._load_bsdf(inner)
        if interior_medium >= 0 or exterior_medium >= 0:
            if mat_id is None:
                # a shape with media and no BSDF is a transparent boundary
                return self.builder.add_material(
                    type=B.NULL, interior_medium=interior_medium,
                    exterior_medium=exterior_medium)
            # a shared row cannot carry one shape's media: a clone does
            rec = dict(self.builder.mats[mat_id])
            rec["interior_medium"] = interior_medium
            rec["exterior_medium"] = exterior_medium
            self.builder.mats.append(rec)
            return len(self.builder.mats) - 1
        if mat_id is None:
            return self.builder.add_material()  # gray diffuse default
        return mat_id

    def _shape_emitter(self, node):
        em = node.find("emitter")
        if em is not None and em.get("type") == "area":
            return _props(em, self.params).get("radiance", (1.0,) * 3)
        return None

    def _load_shape(self, node):
        t = node.get("type")
        p = _props(node, self.params)
        to_world = p.get("toWorld", Transform.identity())
        medium = self._shape_medium(node, "interior")
        ext_medium = self._shape_medium(node, "exterior")
        mat = self._shape_material(node, medium, ext_medium)
        emitter = self._shape_emitter(node)
        flip = bool(p.get("flipNormals", False))
        self._shape_sensor(node, to_world, flip)

        if t in ("obj", "ply", "serialized"):
            path = self.resolve_path(p["filename"])
            meshes = (load_obj(path) if t == "obj"
                      else [load_mesh(path, int(p.get("shapeIndex", 0)))])
            for mesh in meshes:
                v = to_world.apply_point(mesh.positions)
                n = mesh.normals
                if n is not None and not bool(p.get("faceNormals", False)):
                    n = to_world.apply_normal(n)
                    n = n / np.maximum(
                        np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
                else:
                    n = None
                if flip and n is not None:
                    n = -n
                faces = mesh.faces
                if to_world.det3 < 0:
                    faces = faces[:, [0, 2, 1]]
                self.builder.add_mesh(v, faces, mat, emitter_radiance=emitter,
                                      normals=n, uvs=mesh.uvs)
        elif t in ("rectangle", "cube", "disk"):
            v, f, uv = getattr(shapes_mod, t)(to_world)
            if (to_world.det3 < 0) != flip:
                f = f[:, [0, 2, 1]]
            self.builder.add_mesh(v, f, mat, emitter_radiance=emitter, uvs=uv)
        elif t == "sphere":
            center = np.asarray(p.get("center", (0.0, 0.0, 0.0)))
            radius = float(p.get("radius", 1.0))
            if "toWorld" in p:
                center = to_world.apply_point(center)
                radius = radius * abs(to_world.det3) ** (1 / 3)
            if emitter is not None:
                # area emitters need triangles for NEE: tessellate finely
                v, f, n, uv = shapes_mod.sphere_mesh(center, radius, 48, 96)
                self.builder.add_mesh(v, f, mat, emitter_radiance=emitter,
                                      normals=n, uvs=uv)
            else:
                self.builder.add_sphere(center, radius, mat)
        elif t == "cylinder":
            p0 = np.asarray(p.get("p0", (0, 0, 0)), float)
            p1 = np.asarray(p.get("p1", (0, 0, 1)), float)
            if "toWorld" in p:
                p0 = to_world.apply_point(p0)
                p1 = to_world.apply_point(p1)
            v, f, n, uv = shapes_mod.cylinder_mesh(
                p0, p1, float(p.get("radius", 1.0)))
            self.builder.add_mesh(v, f, mat, emitter_radiance=emitter,
                                  normals=n, uvs=uv)
        else:
            log.warning(f"scene: ignoring unsupported shape type '{t}'")

    def _shape_sensor(self, node, to_world, flip):
        """A meter nested in a shape (data/tests/test_bidir_0.xml style): at
        the shape's origin along its +z (-z when ``flip``); an irradiance
        meter's disk takes the transform's x scale as its radius."""
        sn = node.find("sensor")
        if sn is None:
            return
        t = sn.get("type")
        if t not in _METERS:
            log.warning(f"scene: unsupported shape-attached sensor '{t}'")
            return
        n = to_world.apply_vector([0, 0, 1])
        n = n / np.linalg.norm(n)
        r = (float(np.linalg.norm(to_world.apply_vector([1, 0, 0])))
             if t == "irradiancemeter" else 0.0)
        self.sensor = self._meter(t, to_world.apply_point([0, 0, 0]),
                                  -n if flip else n, r)
        self.width = self.height = 1
        samp = sn.find("sampler")
        if samp is not None:
            sp = _props(samp, self.params)
            self.spp = int(sp.get("sampleCount", 16))
            self.sampler_type = _SAMPLERS.get(samp.get("type"),
                                              api_mod.INDEPENDENT)
        film = sn.find("film")
        if film is not None:
            fp = _props(film, self.params)
            self.width = int(fp.get("width", 1))
            self.height = int(fp.get("height", 1))

    def _meter(self, t, o, n, radius=0.0):
        """The meter of type name ``t`` at ``o`` along ``n`` (an irradiance
        meter's disk of ``radius``)."""
        if t == "radiancemeter":
            return sensor_mod.make_radiancemeter(o, n, device=self.device)
        if t == "irradiancemeter":
            return sensor_mod.make_irradiancemeter(o, n, radius,
                                                   device=self.device)
        return sensor_mod.make_fluencemeter(o, device=self.device)

    def _load_emitter(self, node):
        t = node.get("type")
        p = _props(node, self.params)
        if t in _LATER_EMITTERS:
            raise _later(f"the {t} emitter", _LATER_EMITTERS[t])
        if t == "point":
            self.builder.add_point_light(p.get("position", (0, 0, 0)),
                                         p.get("intensity", (1.0,) * 3))
        elif t == "constant":
            self.builder.add_constant_emitter(p.get("radiance", (1.0,) * 3))
        elif t == "directional":
            self.builder.add_directional_light(
                p.get("direction", (0, 0, -1)),
                p.get("irradiance", (1.0,) * 3))
        elif t in ("spot", "collimated"):
            # at toWorld's origin, along its +z
            to_world = p.get("toWorld", Transform.identity())
            o = to_world.apply_point([0, 0, 0])
            d = to_world.apply_vector([0, 0, 1])
            if t == "spot":
                cutoff = p.get("cutoffAngle", 20.0)
                self.builder.add_spot_light(
                    o, d, p.get("intensity", (1.0,) * 3),
                    cutoff_deg=float(cutoff),
                    beamwidth_deg=float(p.get("beamWidth", cutoff * 0.75)))
            else:
                self.builder.add_collimated_beam(o, d,
                                                 p.get("power", (1.0,) * 3))
        elif t == "envmap":
            try:
                img = _load_image(self.resolve_path(p["filename"]))
            except OSError as e:  # FileNotFoundError included
                log.warning(f"scene: envmap '{p.get('filename')}' "
                            f"unreadable ({e}); skipping emitter")
                return
            to_world = p.get("toWorld", Transform.identity())
            self.builder.add_envmap(img, to_world=to_world.m[:3, :3],
                                    scale=float(p.get("scale", 1.0)))
        elif t in ("sunsky", "sky", "sun"):
            self._load_sunsky(t, p)
        else:
            log.warning(f"scene: ignoring unsupported emitter type '{t}'")

    def _load_sunsky(self, t, p):
        """A sun, sky or sunsky element (the JAX loader's branch): the sky
        baked on the host into a (resolution / 2, resolution) lat-long map
        for ``add_envmap``, the sun a directional light of the disk's
        irradiance, the map added first."""
        turb = float(p.get("turbidity", 3.0))
        if "sunDirection" in p:
            sd = np.asarray(p["sunDirection"], np.float64)
            sd = sd / np.linalg.norm(sd)
        else:
            sd = sunsky_mod.sun_direction(
                int(p.get("year", 2010)), int(p.get("month", 7)),
                int(p.get("day", 10)), float(p.get("hour", 15.0)),
                float(p.get("minute", 0.0)), float(p.get("second", 0.0)),
                float(p.get("latitude", 35.6894)),
                float(p.get("longitude", 139.6917)),
                float(p.get("timezone", 9.0)))
        res = int(p.get("resolution", 256))
        if t in ("sky", "sunsky"):
            alb = p.get("albedo", (0.2, 0.2, 0.2))
            if np.isscalar(alb):
                alb = (float(alb),) * 3
            img = sunsky_mod.bake_sky_envmap(
                sd, turbidity=turb, resolution=(res // 2, res),
                scale=float(p.get("scale", 1.0))
                * float(p.get("skyScale", 1.0)),
                extend_below=bool(p.get("extend", True)),
                model=str(p.get("model", "hosek")), albedo=tuple(alb))
            self.builder.add_envmap(img)
        if t in ("sun", "sunsky"):
            irr = sunsky_mod.sun_directional_irradiance(
                sd, turbidity=turb,
                sun_scale=float(p.get("sunScale", 1.0))
                * float(p.get("scale", 1.0)))
            self.builder.add_directional_light(tuple(-sd), tuple(irr))


def _load_image(path: str) -> np.ndarray:
    """An HDR image (EXR or PFM) as linear float RGB. Other formats need an
    image library, which the card's host lacks."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".exr":
        from .image import read_exr

        return read_exr(path)
    if ext == ".pfm":
        from .image import read_pfm

        img = read_pfm(path)
        return img if img.ndim == 3 else np.repeat(img[..., None], 3, -1)
    raise _later(f"loading {ext} images", "3.13")


def load_scene(path: str, defines: Optional[dict] = None,
               device=None) -> LoadedScene:
    """SceneHandler::loadScene: the scene, sensor, integrator and render
    settings of a scene file, built on ``device`` (CUDA by default)."""
    return XMLSceneLoader(path, defines, device).load()


def render_scene_file(path: str, defines: Optional[dict] = None,
                      output: Optional[str] = None, device=None):
    """One-call render of a scene file (the ``mitsuba scene.xml`` flow);
    writes the image to ``output`` when given. Returns the (H, W, 3)
    image."""
    ls = load_scene(path, defines, device)
    img = api_mod.render(ls.scene, ls.static, ls.sensor, ls.integrator,
                         ls.settings, device=ls.scene.tri_p0.device)
    if output:
        from .image import write_image

        write_image(output, img.cpu().numpy())
    return img
