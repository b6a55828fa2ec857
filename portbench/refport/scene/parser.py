"""pbrt scene-description parser, a subset (counterpart of
pbrt_tpu_torch/scene/parser.py), cut to what the benchmark's scenes use.

The program's pipeline, kept: regex tokenizer -> typed parameter lists
(`ParamSet`) -> directive loop over a graphics state -> SceneBuilder ->
compiled scene on the device the caller names. The directives handled:

    LookAt, Translate, Scale, Rotate, Transform, ConcatTransform
    Camera "perspective" (pinhole), Film "rgb", Sampler "zsobol",
    Integrator "path" (its "string lightsampler": uniform, power, bvh,
      exhaustive); WorldBegin, AttributeBegin, AttributeEnd
    Material / MakeNamedMaterial / NamedMaterial, types "diffuse" (its
      reflectance a value or a texture), "conductor", "dielectric" /
      "glass" (smooth or rough)
    Texture "name" "spectrum" "imagemap" (.png through the sRGB curve,
      .exr, .pfm; uscale, vscale, scale; the uv mapping)
    AreaLightSource "diffuse"; LightSource "infinite", an L (uniform) or
      an image file (.exr, .pfm or .png) in the equal-area square
    Shape "trianglemesh", Shape "plymesh"

Spectrum parameters take rgb values, inline [lambda value ...] lists,
named spectra (utils/spectrum.get_named_spectrum) and constants.

Any other directive, type or parameter that changes the image raises
ParseError with the file location: it is not in the benchmark's
reference. Among them, what the program renders and this copy refuses:
Shape "sphere", "disk", "cylinder" (the quadrics and the sphere light),
"curve", "bilinearmesh"; ObjectBegin, ObjectEnd, ObjectInstance;
MakeNamedMedium, MediumInterface and Integrator "volpath". The scene
builder refuses, as the program's does, a bvh or exhaustive light sampler
beside an infinite light.
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
from ..utils import color as pcolor
from ..utils import image
from . import plyio
from ..utils import spectrum as spc
from ..utils import transform as tfm


class ParseError(ValueError):
    """Scene-description error, prefixed with 'file:line:col'."""


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
    "ObjectBegin": "", "ObjectEnd": "", "ObjectInstance": "",
    "MakeNamedMedium": "", "MediumInterface": "",
}
# what the benchmark's reference leaves out: the program ports it
_NOT_HERE = "not in the benchmark's reference"


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
        self.material = 0
        self.area_light = None  # (Spectrum, scale, two_sided)


class PbrtSceneDescription:
    """What a .pbrt file defines: the compiled scene, the camera and the
    render options."""

    def __init__(self, scene, camera, sampler, filter_, integrator,
                 film_params):
        self.scene = scene
        self.camera = camera
        self.sampler = sampler
        self.filter = filter_
        self.integrator = integrator      # dict(name ("path"), max_depth)
        self.film_params = film_params    # dict(xres, yres, filename)


def parse_file(path, **overrides) -> PbrtSceneDescription:
    text = Path(path).read_bytes()
    return parse_string(text, base_dir=Path(path).parent, fname=str(path),
                        **overrides)


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
    cam_params = dict(fov=90.0, camera_from_world=tfm.identity())
    film_params = dict(xres=1280, yres=720, filename="out.exr")
    spp = 16
    integrator = dict(name="path", max_depth=5)
    named_textures = {}     # Texture name -> its texture-pool row

    def refuse(what, where, pos=None):
        raise ParseError(f"{p.loc(pos)}: {what} is not ported yet "
                         f"(ROADMAP.md {where})" if where != _NOT_HERE and
                         where else f"{p.loc(pos)}: {what} is {_NOT_HERE}")

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
            refuse(f"material '{name}'", _NOT_HERE)
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
            if name != "path":
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
        elif tok in ("AttributeEnd", "TransformEnd"):
            if not stack:
                raise ParseError(f"{p.loc(dpos)}: unmatched {tok}")
            gs.__dict__.update(stack.pop())
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
                refuse("a lat-long image light", _NOT_HERE, dpos)
            b.add_image_infinite_light(img, ps.float("scale", 1.0))
        elif tok == "Shape":
            name = p.parse_string()
            ps = p.parse_params()
            if name not in ("trianglemesh", "plymesh"):
                refuse(f"shape '{name}'", _NOT_HERE, dpos)
            add_mesh(*(trianglemesh_data if name == "trianglemesh"
                       else plymesh_data)(ps))
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
