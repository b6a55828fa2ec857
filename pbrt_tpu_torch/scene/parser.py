"""pbrt scene-description parser, a subset (counterpart of
pbrt_tpu/scene/parser.py).

The reference's pipeline, kept: regex tokenizer -> typed parameter lists
(`ParamSet`) -> directive loop over a graphics state -> SceneBuilder ->
compiled scene on the device the caller names. The directives handled are
those of scenes/cornell.pbrt, scenes/meshfield.pbrt, scenes/instances.pbrt
and scenes/patches.pbrt:

    LookAt, Translate, Scale, Rotate, Transform, ConcatTransform
    Camera "perspective" (pinhole), Film "rgb", Sampler "zsobol",
    Integrator "path", WorldBegin, AttributeBegin, AttributeEnd
    Material / MakeNamedMaterial / NamedMaterial, types "diffuse", "hair"
    AreaLightSource "diffuse", LightSource "infinite" (an L, no file)
    Shape "trianglemesh", Shape "curve" (cubic Bezier, the hair scene)
    Shape "bilinearmesh" (exact patches, or two triangles a quad)
    ObjectBegin, ObjectEnd, ObjectInstance (static instances)

Any other directive, type or parameter that changes the image raises
ParseError with the file location and the ROADMAP item that brings it.
"""
from __future__ import annotations

import bisect
import copy
import re
from pathlib import Path

import numpy as np

from .. import cameras as cam_mod
from .. import filters as flt
from .. import samplers as smp
from .. import scene_core as sc
from ..utils import color as pcolor
from ..utils import spectrum as spc
from ..utils import transform as tfm


class ParseError(ValueError):
    """Scene-description error, prefixed with 'file:line:col'."""


_TOKEN_RE = re.compile(rb'"[^"]*"|\[|\]|[^\s"\[\]#]+|#[^\n]*')

# where each refused directive or type is queued (ROADMAP.md)
_LATER = {
    "Include": "slice 6 (front end)", "Import": "slice 6 (front end)",
    "Texture": "slice 3 item 9 (textures)",
    "MakeNamedMedium": "slice 3 item 13 (volume)",
    "MediumInterface": "slice 4 item 19 (medium interfaces)",
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
        """An rgb or an inline [lambda value ...] spectrum parameter.
        Returns None for a type this subset does not read (named spectra,
        files, blackbody)."""
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
        if ty == "spectrum" and not isinstance(vals[0], str):
            arr = np.asarray(vals, np.float64)
            return spc.PiecewiseLinearSpectrum(arr[0::2], arr[1::2])
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
        self.integrator = integrator      # dict(name, max_depth)
        self.film_params = film_params    # dict(xres, yres, filename)


def parse_file(path, **overrides) -> PbrtSceneDescription:
    text = Path(path).read_bytes()
    return parse_string(text, fname=str(path), **overrides)


def parse_string(text, light_sampler="power", force_bvh=None, fname=None,
                 device="cuda") -> PbrtSceneDescription:
    """Parse a scene and build it on `device`. light_sampler and force_bvh
    pass to SceneBuilder.build (an Integrator's "string lightsampler"
    overrides light_sampler, as in the reference)."""
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

    def refuse(what, where, pos=None):
        raise ParseError(f"{p.loc(pos)}: {what} is not ported yet "
                         f"(ROADMAP.md {where})")

    def spectrum_param(ps, name, kind, default):
        s = ps.spectrum(name, cs, kind=kind, default=default)
        if s is None:
            refuse(f"a {ps.d[name][0]} '{name}' value",
                   "slice 6 (named spectra, blackbody, spectrum files)")
        return s

    def make_material(name, ps: ParamSet) -> int:
        if name == "hair":
            sig = ps.rgb("sigma_a", None)
            if sig is None:
                # the reference's default (eumelanin concentration 1.3)
                sig = (0.227, 0.419, 0.805)
            return b.materials.add_hair(sigma_a=sig,
                                        beta_m=ps.float("beta_m", 0.3),
                                        beta_n=ps.float("beta_n", 0.3),
                                        eta=ps.float("eta", 1.55))
        if name not in ("diffuse", "matte"):
            refuse(f"material '{name}'",
                   "slice 3 (envlit: conductor, dielectric; killeroo/plytex: "
                   "rough dielectric; machines frame: coated diffuse, "
                   "subsurface)")
        if ps.texture_name("reflectance") is not None:
            refuse("a textured reflectance", "slice 3 item 9 (textures)")
        refl = ps.rgb("reflectance", None)
        if refl is None:
            if "reflectance" in ps.d:
                refuse(f"a {ps.d['reflectance'][0]} reflectance",
                       "slice 6 (spectral reflectances)")
            refl = (0.5, 0.5, 0.5)
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
            if name != "path":
                refuse(f"integrator '{name}'",
                       "slice 5 (the integrator family)", dpos)
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
        elif tok == "AreaLightSource":
            name = p.parse_string()
            ps = p.parse_params()
            if name != "diffuse":
                refuse(f"area light '{name}'", "slice 3", dpos)
            if ps.string("filename", None) is not None:
                refuse("an image area light", "slice 3 item 9", dpos)
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
            if ps.string("filename", None) is not None:
                refuse("an image infinite light", "slice 3 item 8 (envlit)",
                       dpos)
            s = spectrum_param(ps, "L", "illuminant", spc.d65_spectrum())
            b.add_uniform_infinite_light(s, ps.float("scale", 1.0))
        elif tok == "Shape":
            name = p.parse_string()
            ps = p.parse_params()
            if name in ("curve", "bilinearmesh") and current_object is None:
                (add_curve if name == "curve" else add_bilinearmesh)(ps)
                continue
            if name != "trianglemesh":
                refuse(f"shape '{name}'" + (" in an object" if name in
                                            ("curve", "bilinearmesh")
                                            else ""),
                       "slices 3-4 (plymesh with killeroo/plytex, quadrics, "
                       "instanced curves and patches)", dpos)
            if current_object is None:
                add_mesh(*trianglemesh_data(ps))
            else:
                objects[current_object]["records"].append(dict(
                    mesh=trianglemesh_data(ps), ctm=gs.ctm, mat=gs.material,
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
