"""pbrt scene-description parser, a subset (counterpart of
pbrt_tpu/scene/parser.py).

The reference's pipeline, kept: regex tokenizer -> typed parameter lists
(`ParamSet`) -> directive loop over a graphics state -> SceneBuilder ->
compiled scene on the device the caller names. The directives handled are
those of scenes/cornell.pbrt, scenes/meshfield.pbrt, scenes/instances.pbrt,
scenes/patches.pbrt, scenes/envlit.pbrt, scenes/manylight.pbrt,
scenes/manylight16k.pbrt, scenes/killeroo.pbrt, scenes/plytex.pbrt and
scenes/volume.pbrt:

    LookAt, Translate, Scale, Rotate, Transform, ConcatTransform
    Camera "perspective" (pinhole), Film "rgb", Sampler "zsobol",
    Integrator "path" or "volpath" (its "string lightsampler": uniform,
      power, bvh, exhaustive), WorldBegin, AttributeBegin, AttributeEnd
    Material / MakeNamedMaterial / NamedMaterial, types "diffuse" (its
      reflectance a value or a texture), "conductor", "dielectric" /
      "glass" (smooth or rough), "hair", and the null material ("",
      "none", "interface") of medium-interface meshes
    Texture "name" "spectrum" "imagemap" (.png through the sRGB curve,
      .exr, .pfm; uscale, vscale, scale; the uv mapping)
    AreaLightSource "diffuse"; LightSource "infinite", an L (uniform) or
      an image file (.exr, .pfm or .png; a lat-long image is resampled to
      the equal-area square)
    Shape "trianglemesh", Shape "plymesh", Shape "curve" (cubic Bezier,
      the hair scene), Shape "bilinearmesh" (exact patches, or two
      triangles a quad), Shape "sphere", "disk", "cylinder" (exact
      quadrics; an emissive sphere that is partial or not uniformly
      scaled is tessellated, as in the reference)
    MakeNamedMedium "homogeneous" | "uniformgrid", MediumInterface (the
      null-material meshes it bounds become interface triangles)
    ObjectBegin, ObjectEnd, ObjectInstance (static instances)

Spectrum parameters take rgb values, inline [lambda value ...] lists,
named spectra (utils/spectrum.get_named_spectrum) and constants.

Any other directive, type or parameter that changes the image raises
ParseError with the file location and the ROADMAP item that brings it.
"""
from __future__ import annotations

import bisect
import copy
import re
from pathlib import Path

import numpy as np
import torch

from .. import cameras as cam_mod
from .. import filters as flt
from .. import samplers as smp
from .. import scene_core as sc
from .. import scenes as scenes_mod
from .. import spans
from ..utils import color as pcolor
from ..utils import image
from ..utils import image_env
from . import plyio
from ..utils import spectrum as spc
from ..utils import transform as tfm


class ParseError(ValueError):
    """Scene-description error, prefixed with 'file:line:col'."""


# subdivisions of the icosphere an emissive partial or non-uniformly scaled
# sphere is tessellated into (the reference parser's default)
SPHERE_SUBDIV = 4

_TOKEN_RE = re.compile(rb'"[^"]*"|\[|\]|[^\s"\[\]#]+|#[^\n]*')

# where each refused directive or type is queued (ROADMAP.md)
_LATER = {
    "Include": "slice 6 (front end)", "Import": "slice 6 (front end)",
    "PixelFilter": "slice 4 item 21 (filters)",
    "Filter": "slice 4 item 21 (filters)",
    "ReverseOrientation": "slice 4 (remaining geometry)",
    "CoordinateSystem": "slice 6 (front end)",
    "CoordSysTransform": "slice 6 (front end)",
    "ActiveTransform": "slice 3 item 10 (animated instances)",
    "TransformTimes": "slice 3 item 10 (animated instances)",
    "Option": "slice 6 (front end)", "Attribute": "slice 6 (front end)",
    "ColorSpace": "slice 6 (front end)",
    "Accelerator": "slice 4 item 20 (kd-tree)",
}


# the textures beyond the spectrum imagemap on uv (item 9 brought that)
_TEXTURES_LATER = ("slice 3 item 9 (the spectrum imagemap on uv); the other "
                  "textures, mappings and texture parameters: item 21")


def tokenize(text: bytes):
    """pbrt tokens: quoted strings (quotes kept), brackets, atoms (numbers
    parsed to float); # comments dropped."""
    return tokenize_with_offsets(text)[0]


def tokenize_with_offsets(text: bytes):
    """(tokens, byte offsets); the offsets give ParseError locations."""
    out, offs = [], []
    for m in _TOKEN_RE.finditer(text):
        t = m.group(0)
        if t.startswith(b"#"):
            continue
        tok = t.decode("utf-8")
        if tok not in ("[", "]") and not tok.startswith('"'):
            try:
                out.append(float(tok))
                offs.append(m.start())
                continue
            except ValueError:
                pass
        out.append(tok)
        offs.append(m.start())
    return out, offs


class ParamSet:
    """Typed parameter dictionary (reference ParameterDictionary)."""

    def __init__(self, pairs):
        self.d = {}  # name -> (type, values)
        for (ty, name), vals in pairs:
            self.d[name] = (ty, vals)

    def _get(self, name, types=None):
        if name not in self.d:
            return None
        ty, vals = self.d[name]
        if types and ty not in types:
            return None
        return vals

    def float(self, name, default=None):
        v = self._get(name, ("float", "integer"))
        return float(v[0]) if v else default

    def int(self, name, default=None):
        v = self._get(name, ("integer", "float"))
        return int(v[0]) if v else default

    def ints(self, name, default=None):
        v = self._get(name, ("integer",))
        return np.asarray(v, np.int64) if v is not None else default

    def floats(self, name, default=None):
        v = self._get(name, ("float", "integer"))
        return np.asarray(v, np.float64) if v is not None else default

    def bool(self, name, default=None):
        v = self._get(name, ("bool",))
        if v is None:
            return default
        return v[0] in (True, "true", "\"true\"")

    def string(self, name, default=None):
        v = self._get(name, ("string", "texture"))
        return v[0] if v else default

    def point3s(self, name, default=None):
        v = self._get(name, ("point3", "point", "vector3", "vector", "normal",
                             "normal3"))
        return np.asarray(v, np.float64).reshape(-1, 3) if v is not None \
            else default

    def point2s(self, name, default=None):
        v = self._get(name, ("point2", "float"))
        return np.asarray(v, np.float64).reshape(-1, 2) if v is not None \
            else default

    def rgb(self, name, default=None):
        v = self._get(name, ("rgb", "color"))
        return np.asarray(v, np.float64) if v is not None else default

    def texture_name(self, name):
        ty_v = self.d.get(name)
        if ty_v and ty_v[0] == "texture":
            return ty_v[1][0]
        return None

    def spectrum(self, name, cs, kind="albedo", default=None):
        """An rgb, named, constant or inline [lambda value ...] spectrum
        parameter. Returns None for a type this subset does not read
        (spectrum files, blackbody)."""
        if name not in self.d:
            return default
        ty, vals = self.d[name]
        if ty in ("rgb", "color"):
            rgb = np.asarray(vals, np.float64)
            if kind == "illuminant":
                return pcolor.RGBIlluminantSpectrum(rgb, cs)
            if kind == "unbounded":
                return pcolor.RGBUnboundedSpectrum(rgb, cs)
            return pcolor.RGBAlbedoSpectrum(np.clip(rgb, 0, 1), cs)
        if ty == "spectrum":
            if isinstance(vals[0], str):
                return spc.get_named_spectrum(vals[0])
            arr = np.asarray(vals, np.float64)
            return spc.PiecewiseLinearSpectrum(arr[0::2], arr[1::2])
        if ty in ("float", "integer"):
            return spc.ConstantSpectrum(float(vals[0]))
        return None


def _parse_value(tok):
    if isinstance(tok, float):
        return tok
    if tok.startswith('"'):
        return tok[1:-1]
    if tok == "true":
        return True
    if tok == "false":
        return False
    return float(tok)


class Parser:
    """Token cursor with file locations (reference FileLoc)."""

    def __init__(self, tokens, offsets=None, fname=None, text=None):
        self.toks = tokens
        self.pos = 0
        self.offsets = offsets
        self.fname = fname
        self.text = text
        self._nl = None

    def loc(self, pos=None) -> str:
        """'file:line:col' of the token at pos (default: last consumed)."""
        if self.offsets is None or self.text is None:
            return f"{self.fname or '<scene>'}:token {self.pos}"
        pos = self.pos - 1 if pos is None else pos
        pos = min(max(pos, 0), len(self.offsets) - 1)
        off = self.offsets[pos]
        if self._nl is None:
            self._nl = np.nonzero(np.frombuffer(self.text, np.uint8)
                                  == 0x0A)[0]
        i = bisect.bisect_left(self._nl, off)
        col = off - (int(self._nl[i - 1]) + 1 if i > 0 else 0) + 1
        return f"{self.fname or '<scene>'}:{i + 1}:{col}"

    def peek(self):
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self):
        if self.pos >= len(self.toks):
            raise ParseError(f"{self.loc()}: unexpected end of file")
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def parse_params(self) -> ParamSet:
        """'"type name" [values...]' pairs until the next directive."""
        pairs = []
        while True:
            t = self.peek()
            if t is None or not isinstance(t, str) or not t.startswith('"'):
                break
            decl = self.next()[1:-1].split()
            if len(decl) == 1:
                self.pos -= 1    # a bare string argument: put it back
                break
            ty, name = decl[0], " ".join(decl[1:])
            vals = []
            if self.peek() == "[":
                self.next()
                while self.peek() != "]":
                    vals.append(_parse_value(self.next()))
                self.next()
            else:
                vals.append(_parse_value(self.next()))
            pairs.append(((ty, name), vals))
        return ParamSet(pairs)

    def parse_args(self, n):
        return [_parse_value(self.next()) for _ in range(n)]

    def parse_string(self):
        t = self.next()
        if not isinstance(t, str) or not t.startswith('"'):
            raise ParseError(f"{self.loc()}: expected a quoted string, got "
                             f"{t!r}")
        return t[1:-1]

    def parse_matrix(self):
        if self.next() != "[":
            raise ParseError(f"{self.loc()}: expected '[' before a matrix")
        m = [float(self.next()) for _ in range(16)]
        if self.next() != "]":
            raise ParseError(f"{self.loc()}: expected ']' after 16 numbers")
        return np.asarray(m).reshape(4, 4).T


class GraphicsState:
    def __init__(self):
        self.ctm = tfm.identity()
        self.material = 0       # -1: the null material (interfaces)
        self.area_light = None  # (Spectrum, scale, two_sided)
        self.medium_interface = None  # (inside, outside) medium names


class PbrtSceneDescription:
    """What a .pbrt file defines: the compiled scene, the camera and the
    render options."""

    def __init__(self, scene, camera, sampler, filter_, integrator,
                 film_params):
        self.scene = scene
        self.camera = camera
        self.sampler = sampler
        self.filter = filter_
        self.integrator = integrator      # dict(name ("path" or
        #                                   "volpath"), max_depth)
        self.film_params = film_params    # dict(xres, yres, filename)


def parse_file(path, **overrides) -> PbrtSceneDescription:
    text = Path(path).read_bytes()
    return parse_string(text, base_dir=Path(path).parent, fname=str(path),
                        **overrides)


@spans.span("scene.parse")
def parse_string(text, base_dir=".", light_sampler="power", force_bvh=None,
                 fname=None, device="cuda") -> PbrtSceneDescription:
    """Parse a scene and build it on `device`. base_dir: where the files it
    names are read from. light_sampler and force_bvh pass to
    SceneBuilder.build (an Integrator's "string lightsampler" overrides
    light_sampler, as in the reference)."""
    if isinstance(text, str):
        text = text.encode()
    toks, offs = tokenize_with_offsets(text)
    p = Parser(toks, offsets=offs, fname=fname, text=text)
    b = sc.SceneBuilder()
    cs = b.cs
    gs = GraphicsState()
    stack = []
    named_materials = {}
    objects = {}            # ObjectBegin name -> its shapes and base CTM
    current_object = None
    cam_params = dict(fov=90.0, camera_from_world=tfm.identity())
    film_params = dict(xres=1280, yres=720, filename="out.exr")
    spp = 16
    integrator = dict(name="path", max_depth=5)
    named_textures = {}     # Texture name -> its texture-pool row
    named_media = {}        # MakeNamedMedium name -> its medium row

    def refuse(what, where, pos=None):
        raise ParseError(f"{p.loc(pos)}: {what} is not ported yet "
                         f"(ROADMAP.md {where})")

    def spectrum_param(ps, name, kind, default):
        s = ps.spectrum(name, cs, kind=kind, default=default)
        if s is None:
            refuse(f"a {ps.d[name][0]} '{name}' value {ps.d[name][1][:1]}",
                   "slice 6 (blackbody, spectrum files)")
        return s

    def roughness(ps: ParamSet):
        """(roughness, uroughness, vroughness, remaproughness) of a
        microfacet material."""
        for n in ("roughness", "uroughness", "vroughness"):
            if ps.texture_name(n) is not None:
                refuse(f"a textured {n}", _TEXTURES_LATER)
        return (ps.float("roughness", 0.0), ps.float("uroughness", None),
                ps.float("vroughness", None), ps.bool("remaproughness", True))

    def make_material(name, ps: ParamSet) -> int:
        if name in ("", "none", "interface"):
            # the null material: geometry that only bounds media
            return -1
        if name == "hair":
            sig = ps.rgb("sigma_a", None)
            if sig is None:
                # the reference's default (eumelanin concentration 1.3)
                sig = (0.227, 0.419, 0.805)
            return b.materials.add_hair(sigma_a=sig,
                                        beta_m=ps.float("beta_m", 0.3),
                                        beta_n=ps.float("beta_n", 0.3),
                                        eta=ps.float("eta", 1.55))
        if name == "conductor":
            rough, urough, vrough, remap = roughness(ps)
            eta_s = spectrum_param(ps, "eta", "unbounded",
                                   spc.get_named_spectrum("metal-Cu-eta"))
            k_s = spectrum_param(ps, "k", "unbounded",
                                 spc.get_named_spectrum("metal-Cu-k"))
            return b.materials.add_conductor(
                eta_spec_idx=b.add_spectrum(eta_s, key=("mat-eta", id(eta_s))),
                k_spec_idx=b.add_spectrum(k_s, key=("mat-k", id(k_s))),
                roughness=rough, uroughness=urough, vroughness=vrough,
                remap=remap)
        if name in ("dielectric", "glass"):
            rough, urough, vrough, remap = roughness(ps)
            ei = -1
            if ps.d.get("eta", ("", []))[0] == "spectrum":
                es = spectrum_param(ps, "eta", "unbounded", None)
                ei = b.add_spectrum(es, key=("eta", id(es)))
            eta = ps.float("eta", 1.5)
            return b.materials.add_dielectric(
                eta=eta if eta else 1.5, roughness=rough, uroughness=urough,
                vroughness=vrough, remap=remap, eta_spec_idx=ei)
        if name not in ("diffuse", "matte"):
            refuse(f"material '{name}'",
                   "slice 3 (portalbox, item 14: coated diffuse; machines "
                   "frame, item 15: subsurface); slice 4 item 26 (thin "
                   "dielectric, diffuse transmission, coated conductor, mix, "
                   "interface)")
        tn = ps.texture_name("reflectance")
        if tn is not None:
            if tn not in named_textures:
                raise ParseError(f"{p.loc()}: unknown texture '{tn}'")
            return b.materials.add_diffuse(albedo_tex=named_textures[tn])
        refl = ps.rgb("reflectance", None)
        if refl is None:
            refl = (0.5, 0.5, 0.5)
            if "reflectance" in ps.d:
                # a spectral reflectance, through its XYZ to the space's RGB
                s = spectrum_param(ps, "reflectance", "albedo", None)
                refl = np.asarray(s.to_xyz(), np.float32) @ \
                    cs.rgb_from_xyz.astype(np.float32).T
        return b.materials.add_diffuse(tuple(np.clip(refl, 0, 1)))

    def mesh_params(ps: ParamSet, name, corners):
        """(P, indices (F, corners)) of a mesh shape, in its own space."""
        P = ps.point3s("P")
        idx = ps.ints("indices")
        if P is None or idx is None:
            raise ParseError(f"{p.loc()}: {name} needs \"point3 P\" "
                             "and \"integer indices\"")
        if ps.texture_name("alpha") is not None or \
                ps.float("alpha", 1.0) != 1.0:
            refuse("shape alpha", "slice 4 item 18 (textured alpha)")
        return P, idx.reshape(-1, corners)

    def trianglemesh_data(ps: ParamSet):
        """(P, indices, N, uv) of a trianglemesh, in its own space."""
        P, idx = mesh_params(ps, "trianglemesh", 3)
        return (P, idx, ps.point3s("N", None),
                ps.point2s("uv", ps.point2s("st", None)))

    def plymesh_data(ps: ParamSet):
        """(P, indices, N, uv) of a plymesh's file, in its own space."""
        fn = ps.string("filename", None)
        if fn is None:
            raise ParseError(f"{p.loc()}: plymesh needs \"string filename\"")
        if ps.texture_name("alpha") is not None or \
                ps.float("alpha", 1.0) != 1.0:
            refuse("shape alpha", "slice 4 item 18 (textured alpha)")
        if ps.texture_name("displacement") is not None:
            refuse("a displaced plymesh", "slice 4 item 26 (other shapes)")
        mesh = plyio.read_ply(Path(base_dir) / fn)
        return mesh["vertices"], mesh["indices"], mesh["normals"], \
            mesh["uvs"]

    def read_image(fn, pos):
        """A named image file as float32 (H, W, 3): .exr and .pfm as
        stored, .png as bytes over 255."""
        fp = Path(base_dir) / fn
        if fn.endswith(".exr"):
            return image.read_exr(fp)
        if fn.endswith(".pfm"):
            return image.read_pfm(fp)
        if fn.endswith(".png"):
            return image.read_png(fp).astype(np.float32) / 255.0
        refuse(f"the image file '{fn}' (the port reads .exr, .pfm and "
               ".png)", "slice 6 (front end)", pos)

    def add_texture(name, ty, cls, ps: ParamSet, pos):
        """Texture "name" "spectrum" "imagemap" (reference parser, its
        imagemap branch under the uv mapping)."""
        if ty != "spectrum" or cls != "imagemap":
            refuse(f"a '{ty}' '{cls}' texture",
                   _TEXTURES_LATER, pos)
        if ps.string("mapping", "uv") != "uv":
            refuse("a texture mapping other than uv",
                   _TEXTURES_LATER, pos)
        # the reference reads neither offsets nor another wrap mode
        if ps.float("udelta", 0.0) != 0.0 or ps.float("vdelta", 0.0) != 0.0 \
                or ps.string("wrap", "repeat") != "repeat" \
                or ps.bool("invert", False):
            refuse("an imagemap's udelta, vdelta, wrap or invert",
                   _TEXTURES_LATER, pos)
        fn = ps.string("filename", None)
        if fn is None:
            raise ParseError(f"{p.loc(pos)}: imagemap needs filename")
        img = read_image(fn, pos)
        if fn.endswith(".png"):
            img = pcolor.srgb_to_linear(torch.as_tensor(img)).numpy()
        named_textures[name] = b.textures.add_image(
            img[..., :3], su=ps.float("uscale", 1.0),
            sv=ps.float("vscale", 1.0), scale=ps.float("scale", 1.0))

    def add_bilinearmesh(ps: ParamSet):
        """Shape "bilinearmesh" (reference parser): exact patches when the
        mesh has no emission, N or uv and at most 64 quads, else two
        triangles a quad, [0, 1, 3] and [0, 3, 2]."""
        P, qidx = mesh_params(ps, "bilinearmesh", 4)
        N = ps.point3s("N", None)
        uv = ps.point2s("uv", None)
        if gs.area_light is None and N is None and uv is None and \
                len(qidx) <= 64:
            Pw = np.asarray(gs.ctm.apply_point(np.asarray(P, np.float32)))
            for q4 in qidx:
                b.add_bilinear_patch(*(Pw[i] for i in q4), gs.material)
            return
        add_mesh(P, np.concatenate([qidx[:, [0, 1, 3]], qidx[:, [0, 3, 2]]]),
                 N, uv)

    def add_mesh(P, idx, N, uv):
        """A triangle mesh in the current transform, material and area
        light."""
        xf = gs.ctm
        P = np.asarray(xf.apply_point(np.asarray(P, np.float32)))
        if N is not None:
            N = np.asarray(xf.apply_normal(np.asarray(N, np.float32)))
            N = N / np.maximum(np.linalg.norm(N, axis=-1, keepdims=True),
                               1e-20)
        if xf.swaps_handedness():
            idx = np.asarray(idx)[:, ::-1]
        emission, escale, two_sided = gs.area_light or (None, 1.0, False)
        b.add_mesh(P, idx, gs.material, normals=N, uvs=uv, emission=emission,
                   emission_scale=escale, two_sided=two_sided)

    def medium_index(name):
        if name is None:
            return -1
        if name not in named_media:
            raise ParseError(f"{p.loc()}: MediumInterface names unknown "
                             f"medium '{name}'")
        return named_media[name]

    def add_interface(name, ps: ParamSet):
        """A null-material mesh: medium-interface triangles (reference
        instantiate_shape's null-material branch), in world space, the
        winding kept."""
        if name not in ("trianglemesh", "plymesh"):
            raise ParseError(f"{p.loc()}: interface (null-material) shapes "
                             f"are supported for meshes only, not "
                             f"'{name}'")
        P, idx, _n, _uv = (trianglemesh_data if name == "trianglemesh"
                           else plymesh_data)(ps)
        inside, outside = gs.medium_interface or (None, None)
        b.add_interface_mesh(
            np.asarray(gs.ctm.apply_point(np.asarray(P, np.float32))), idx,
            med_in=medium_index(inside), med_out=medium_index(outside))

    def add_quadric(name, ps: ParamSet):
        """Shape "sphere", "disk" or "cylinder" (reference parser.py:
        632-689). Returns the tessellated (P, indices, N, uv) of an
        emissive sphere that is partial or not uniformly scaled, for
        add_mesh; None when the quadric was added."""
        xf = gs.ctm
        emission, escale, _two = gs.area_light or (None, 1.0, False)
        m4 = np.asarray(xf.m, np.float64)
        if name == "disk":
            if emission is not None:
                raise ParseError(f"{p.loc()}: area lights on disks are not "
                                 "supported yet")
            b.add_disk(m4, ps.float("radius", 1.0), gs.material,
                       height=ps.float("height", 0.0),
                       inner_radius=ps.float("innerradius", 0.0),
                       phi_max=np.deg2rad(ps.float("phimax", 360.0)))
            return None
        if name == "cylinder":
            if emission is not None:
                raise ParseError(f"{p.loc()}: area lights on cylinders are "
                                 "not supported yet")
            b.add_cylinder(m4, ps.float("radius", 1.0),
                           ps.float("zmin", -1.0), ps.float("zmax", 1.0),
                           gs.material,
                           phi_max=np.deg2rad(ps.float("phimax", 360.0)))
            return None
        radius = ps.float("radius", 1.0)
        zmin = ps.float("zmin", -radius)
        zmax = ps.float("zmax", radius)
        phimax = ps.float("phimax", 360.0)
        gram = m4[:3, :3] @ m4[:3, :3].T
        s_sq = gram[0, 0]
        uniform = np.allclose(gram, s_sq * np.eye(3), rtol=1e-4) and s_sq > 0
        full = zmin <= -radius + 1e-6 and zmax >= radius - 1e-6 and \
            phimax >= 360.0 - 1e-4
        if uniform and full:
            center = np.asarray(xf.apply_point(np.zeros((1, 3),
                                                        np.float32)))[0]
            b.add_sphere(center, radius * float(np.sqrt(s_sq)), gs.material,
                         emission=emission, emission_scale=escale)
            return None
        if emission is not None:
            P, idx, N = scenes_mod.make_sphere_mesh((0, 0, 0), radius,
                                                    subdiv=SPHERE_SUBDIV)
            return P, idx, N, None
        if not full:
            raise ParseError(f"{p.loc()}: partial spheres (zmin/zmax/phimax) "
                             "are not yet supported as exact quadrics")
        b.add_quadric_sphere(m4, radius, gs.material)
        return None

    def add_medium(nm, ps: ParamSet, pos):
        """MakeNamedMedium (reference parser.py:873-946): homogeneous (in a
        box around the whole scene) or uniformgrid (its density grid in
        the transformed p0, p1 box)."""
        mtype = ps.string("type", "homogeneous")
        g = ps.float("g", 0.0)
        sig_a = tuple(ps.rgb("sigma_a", (1.0,) * 3))
        sig_s = tuple(ps.rgb("sigma_s", (1.0,) * 3))
        mscale = ps.float("scale", 1.0)
        if mtype == "homogeneous":
            named_media[nm] = b.media.add_homogeneous(
                sigma_a=sig_a, sigma_s=sig_s, g=g, scale=mscale)
            return
        if mtype != "uniformgrid":
            refuse(f"medium type '{mtype}'",
                   "slice 3 item 13 (the rgbgrid and cloud media; nanovdb "
                   "with item 23)", pos)
        nx, ny, nz = (ps.int(k, 1) for k in ("nx", "ny", "nz"))
        p0 = ps.point3s("p0", np.zeros((1, 3)))[0]
        p1 = ps.point3s("p1", np.ones((1, 3)))[0]
        wc = np.asarray(gs.ctm.apply_point(np.array([p0, p1], np.float32)))
        dens = ps.floats("density", np.ones(nx * ny * nz))
        named_media[nm] = b.media.add_grid(
            np.asarray(dens, np.float32).reshape(nz, ny, nx),
            np.minimum(wc[0], wc[1]), np.maximum(wc[0], wc[1]),
            sigma_a=sig_a, sigma_s=sig_s, g=g, scale=mscale)

    def add_curve(ps: ParamSet):
        """Shape "curve" (reference parser): bezier only, degree 3, chained
        spans of 3k + 1 points, the width lerped per span, type flat,
        cylinder or ribbon (N: the ribbon's two normals)."""
        if gs.area_light is not None:
            raise ParseError(f"{p.loc()}: emissive curves are not supported")
        cp = np.asarray(ps.point3s("P"), np.float32)
        basis = ps.string("basis", "bezier")
        if basis != "bezier":
            raise ParseError(f"{p.loc()}: curve basis '{basis}' is not "
                             "supported (bezier only; convert b-splines "
                             "upstream)")
        degree = int(ps.float("degree", 3))
        if degree != 3 or cp.shape[0] < 4:
            raise ParseError(f"{p.loc()}: only degree-3 bezier curves with "
                             "4+ control points are supported")
        w = ps.float("width", 1.0)
        w0 = ps.float("width0", w)
        w1 = ps.float("width1", w)
        ctype = ps.string("type", "flat")
        nrm = ps.point3s("N", None)
        cp_w = np.asarray(gs.ctm.apply_point(cp.reshape(-1, 3)), np.float32)
        n_spans = max((cp_w.shape[0] - 1) // 3, 1)
        for si in range(n_spans):
            a = si * 3
            span = cp_w[a:a + 4] if cp_w.shape[0] >= a + 4 else cp_w[-4:]
            u0 = si / n_spans
            u1 = (si + 1) / n_spans
            normals = (nrm[0], nrm[1]) if nrm is not None and len(nrm) >= 2 \
                else None
            b.add_curve(span, w0 + (w1 - w0) * u0, w0 + (w1 - w0) * u1,
                        gs.material, curve_type=ctype, normals=normals)

    def instantiate(name):
        """ObjectInstance (reference parser.py:997-1048): the prototype is
        built at the first instance, its meshes baked relative to the
        object's base CTM (base_inv @ shape CTM), so the instance's
        transform ctm @ base_ctm gives each shape ctm @ shape CTM."""
        obj = objects.get(name)
        if obj is None:
            raise ParseError(f"{p.loc()}: ObjectInstance of unknown object "
                             f"'{name}'")
        if obj["proto"] is None:
            obj["proto"] = b.new_prototype()
            base_inv = obj["base_ctm"].inverse()
            for rec in obj["records"]:
                if rec["emission"] is not None:
                    raise ParseError(f"{p.loc()}: emissive instanced "
                                     "geometry is not supported")
                xf = base_inv @ rec["ctm"]
                P, idx, N, uv = rec["mesh"]
                b.add_proto_mesh(
                    obj["proto"], xf.apply_point(P), idx, rec["mat"],
                    normals=None if N is None else xf.apply_normal(N),
                    uvs=uv)
        b.add_instance(obj["proto"], gs.ctm @ obj["base_ctm"])

    while p.peek() is not None:
        dpos = p.pos
        tok = p.next()
        if not isinstance(tok, str):
            raise ParseError(f"{p.loc(dpos)}: unexpected token {tok!r}")
        if tok == "Identity":
            gs.ctm = tfm.identity()
        elif tok == "Translate":
            gs.ctm = gs.ctm @ tfm.translate(p.parse_args(3))
        elif tok == "Scale":
            gs.ctm = gs.ctm @ tfm.scale(*p.parse_args(3))
        elif tok == "Rotate":
            a = p.parse_args(4)
            gs.ctm = gs.ctm @ tfm.rotate(a[0], a[1:])
        elif tok == "LookAt":
            a = p.parse_args(9)
            gs.ctm = gs.ctm @ tfm.look_at(a[0:3], a[3:6], a[6:9]).inverse()
        elif tok == "Transform":
            gs.ctm = tfm.from_matrix(p.parse_matrix())
        elif tok == "ConcatTransform":
            gs.ctm = gs.ctm @ tfm.from_matrix(p.parse_matrix())
        elif tok == "Camera":
            kind = p.parse_string()
            ps = p.parse_params()
            if kind != "perspective":
                refuse(f"camera '{kind}'",
                       "slice 4 item 21 (the other cameras)", dpos)
            if ps.float("lensradius", 0.0) > 0:
                refuse("a thin-lens camera",
                       "slice 4 item 21 (the other cameras)", dpos)
            cam_params = dict(fov=ps.float("fov", 90.0),
                              camera_from_world=gs.ctm)
        elif tok == "Sampler":
            kind = p.parse_string()
            ps = p.parse_params()
            if kind != "zsobol":
                refuse(f"sampler '{kind}'",
                       "slice 4 item 21 (the other samplers)", dpos)
            spp = ps.int("pixelsamples", 16)
        elif tok == "Film":
            kind = p.parse_string()
            ps = p.parse_params()
            if kind != "rgb":
                refuse(f"film '{kind}'", "slice 6 (films and sensors)",
                       dpos)
            if ps.string("sensor", "cie1931") != "cie1931":
                refuse("a named pixel sensor", "slice 6 (sensors)", dpos)
            film_params = dict(xres=ps.int("xresolution", 1280),
                               yres=ps.int("yresolution", 720),
                               filename=ps.string("filename", "out.exr"))
        elif tok == "Integrator":
            name = p.parse_string()
            ps = p.parse_params()
            if name not in ("path", "volpath"):
                refuse(f"integrator '{name}'",
                       "slice 5 item 22 (the integrator family)", dpos)
            integrator = dict(name=name, max_depth=ps.int("maxdepth", 5))
            light_sampler = ps.string("lightsampler", light_sampler)
        elif tok == "WorldBegin":
            gs.ctm = tfm.identity()
        elif tok == "WorldEnd":
            pass
        elif tok in ("AttributeBegin", "TransformBegin"):
            stack.append(copy.copy(gs.__dict__))
        elif tok in ("AttributeEnd", "TransformEnd", "ObjectEnd"):
            if not stack:
                raise ParseError(f"{p.loc(dpos)}: unmatched {tok}")
            gs.__dict__.update(stack.pop())
            if tok == "ObjectEnd":
                current_object = None
        elif tok == "ObjectBegin":
            current_object = p.parse_string()
            objects[current_object] = dict(records=[], base_ctm=gs.ctm,
                                           proto=None)
            stack.append(copy.copy(gs.__dict__))
        elif tok == "ObjectInstance":
            instantiate(p.parse_string())
        elif tok == "Material":
            name = p.parse_string()
            gs.material = make_material(name, p.parse_params())
        elif tok == "MakeNamedMaterial":
            nm = p.parse_string()
            ps = p.parse_params()
            named_materials[nm] = make_material(ps.string("type", "diffuse"),
                                                ps)
        elif tok == "NamedMaterial":
            gs.material = named_materials.get(p.parse_string(), 0)
        elif tok == "Texture":
            tname, ty, cls = (p.parse_string() for _ in range(3))
            add_texture(tname, ty, cls, p.parse_params(), dpos)
        elif tok == "AreaLightSource":
            name = p.parse_string()
            ps = p.parse_params()
            if name != "diffuse":
                refuse(f"area light '{name}'", "slice 3", dpos)
            if ps.string("filename", None) is not None:
                refuse("an image area light", _TEXTURES_LATER, dpos)
            s = spectrum_param(ps, "L", "illuminant", spc.d65_spectrum())
            gs.area_light = (s, ps.float("scale", 1.0),
                             ps.bool("twosided", False))
        elif tok == "LightSource":
            name = p.parse_string()
            ps = p.parse_params()
            if name != "infinite":
                refuse(f"light '{name}'",
                       "slice 3 (point, spot, distant, projection, "
                       "goniometric lights)", dpos)
            fn = ps.string("filename", None)
            if fn is None:
                s = spectrum_param(ps, "L", "illuminant", spc.d65_spectrum())
                b.add_uniform_infinite_light(s, ps.float("scale", 1.0))
                continue
            if ps.point3s("portal", None) is not None:
                refuse("a portal image light", "slice 3 item 14 (portalbox)",
                       dpos)
            img = read_image(fn, dpos)
            if img.shape[0] != img.shape[1]:
                # lat-long: resample to the equal-area square
                img = image_env.equalarea_from_latlong(img)
            b.add_image_infinite_light(img, ps.float("scale", 1.0))
        elif tok == "MakeNamedMedium":
            add_medium(p.parse_string(), p.parse_params(), dpos)
        elif tok == "MediumInterface":
            inside = p.parse_string()
            outside = ""
            if isinstance(p.peek(), str) and p.peek().startswith('"'):
                outside = p.parse_string()
            gs.medium_interface = (inside or None, outside or None)
        elif tok == "Shape":
            name = p.parse_string()
            ps = p.parse_params()
            if current_object is None and gs.material == -1:
                add_interface(name, ps)
                continue
            if name in ("curve", "bilinearmesh") and current_object is None:
                (add_curve if name == "curve" else add_bilinearmesh)(ps)
                continue
            data = None
            if name in ("sphere", "disk", "cylinder") and \
                    current_object is None:
                data = add_quadric(name, ps)
                if data is None:
                    continue
            elif name in ("curve", "bilinearmesh", "sphere", "disk",
                          "cylinder"):
                refuse(f"shape '{name}' in an object", "slice 3 item 10 "
                       "(instanced curves, patches and quadrics)", dpos)
            elif name not in ("trianglemesh", "plymesh"):
                refuse(f"shape '{name}'",
                       "slice 4 item 26 (the other shapes)", dpos)
            if current_object is not None and gs.material == -1:
                refuse("a null-material shape in an object",
                       "slice 3 item 10 (instanced medium interfaces)", dpos)
            if data is None:
                data = (trianglemesh_data if name == "trianglemesh"
                        else plymesh_data)(ps)
            if current_object is None:
                add_mesh(*data)
            else:
                objects[current_object]["records"].append(dict(
                    mesh=data, ctm=gs.ctm, mat=gs.material,
                    emission=(gs.area_light or (None,))[0]))
        elif tok in _LATER:
            refuse(f"directive '{tok}'", _LATER[tok], dpos)
        else:
            raise ParseError(f"{p.loc(dpos)}: unknown directive {tok!r}")

    scene = b.build(light_sampler=light_sampler, force_bvh=force_bvh,
                    device=device)
    camera = cam_mod.make_camera(
        "perspective", camera_from_world=cam_params["camera_from_world"],
        width=film_params["xres"], height=film_params["yres"],
        fov=cam_params["fov"])
    sampler = smp.make_sampler("zsobol", spp=spp,
                               full_resolution=(film_params["xres"],
                                                film_params["yres"]))
    return PbrtSceneDescription(scene, camera, sampler,
                                flt.make_filter("gaussian"), integrator,
                                film_params)
