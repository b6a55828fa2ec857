"""Port vs reference: the .pbrt parser subset.

The golden scene files of the ported slices parse in both packages to
the same tokens and the same scene tables, array for array and bit for
bit: triangle vertices, shading rows (normals, uvs, material, light),
material rows, light rows, the spectrum pool, the camera matrix, and the
film, sampler and integrator parameters. A directive outside the subset
raises ParseError with its location and the ROADMAP item that brings it.
"""
import os
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pbrt_tpu.scene import parser as jparser  # noqa: E402
from pbrt_tpu_torch.scene import parser  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
SCENES = ["cornell", "meshfield", "instances"]


@pytest.mark.parametrize("name", SCENES)
def test_tokens_match_reference(name):
    text = (ROOT / "scenes" / f"{name}.pbrt").read_bytes()
    assert parser.tokenize(text) == jparser.tokenize(text)


def _compare(dj, dp):
    sj, sp = dj.scene, dp.scene
    tri = sp.tri_all.numpy()
    ref = np.asarray(sj.tri_all)
    for what, cols in (("vertices", slice(0, 9)), ("ids", slice(9, 10)),
                       ("shade rows", slice(10, 27))):
        np.testing.assert_array_equal(tri[:, cols], ref[:, cols],
                                      err_msg=what)
    for what, got, want in (
            ("material rows", sp.mat_pool, sj.materials.packed),
            ("light rows", sp.lights_packed, sj.lights.packed),
            ("spectra_pool", sp.spectra_pool, sj.spectra_pool)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=what)
    np.testing.assert_array_equal(dp.camera.c2w_m, np.asarray(dj.camera.c2w_m))
    assert dp.camera.tan_half_fov == np.asarray(dj.camera.tan_half_fov)
    assert (dp.camera.width, dp.camera.height, dp.camera.screen_min,
            dp.camera.screen_max) == (dj.camera.width, dj.camera.height,
                                      dj.camera.screen_min,
                                      dj.camera.screen_max)
    assert dp.film_params == dj.film_params
    assert dp.integrator == dj.integrator
    for f in ("spp", "seed", "log2_spp", "n_base4_digits"):
        assert getattr(dp.sampler, f) == getattr(dj.sampler, f), f
    assert sp.scene_radius == float(sj.scene_radius)
    assert sp.inf_indices == tuple(sj.inf_indices)
    assert sp.use_bvh == sj.use_bvh
    assert sp.light_sampler.kind == sj.light_sampler.kind
    np.testing.assert_array_equal(sp.light_sampler.pmf_table,
                                  np.asarray(sj.light_sampler.pmf_table))
    assert (sp.mega is None) == (sj.mega is None)
    if sp.mega is not None:
        assert sp.mega._asdict() == sj.mega._asdict()


@pytest.mark.parametrize("name", SCENES)
def test_parse_file_matches_reference(name):
    path = ROOT / "scenes" / f"{name}.pbrt"
    _compare(jparser.parse_file(path),
             parser.parse_file(path, device="cpu"))


TRANSFORMED = b"""
LookAt 1 2 3  0 0.5 0  0 1 0
Camera "perspective" "float fov" [40]
Film "rgb" "integer xresolution" [12] "integer yresolution" [10]
Sampler "zsobol" "integer pixelsamples" [4]
Integrator "path" "integer maxdepth" [3] "string lightsampler" "uniform"
WorldBegin
LightSource "infinite" "rgb L" [0.2 0.3 0.4] "float scale" [2]
AttributeBegin
  Translate 0.5 0 -1
  Rotate 30 0 1 1
  Scale 1 -2 1
  Material "diffuse" "rgb reflectance" [0.2 0.8 0.1]
  Shape "trianglemesh" "integer indices" [0 1 2 2 1 3]
    "point3 P" [0 0 0  1 0 0  0 1 0  1 1 0.5]
    "normal N" [0 0 1  0 0.2 1  0.1 0 1  0 0 1]
    "point2 uv" [0 0  1 0  0 1  1 1]
AttributeEnd
AttributeBegin
  ConcatTransform [1 0 0 0  0 1 0 0  0 0 1 0  0 3 0 1]
  AreaLightSource "diffuse" "rgb L" [4 3 2] "bool twosided" true
  Shape "trianglemesh" "integer indices" [0 1 2]
    "point3 P" [0 0 0  1 0 0  0 0 1]
AttributeEnd
Transform [2 0 0 0  0 2 0 0  0 0 2 0  0 0 0 1]
MakeNamedMaterial "grey" "string type" "diffuse"
NamedMaterial "grey"
Shape "trianglemesh" "integer indices" [0 1 2] "point3 P" [0 0 0 0 1 0 1 0 0]
"""


def test_transforms_normals_and_lights_match_reference():
    _compare(jparser.parse_string(TRANSFORMED),
             parser.parse_string(TRANSFORMED, device="cpu"))


@pytest.mark.parametrize("snippet, item", [
    (b'Shape "loopsubdiv" "integer levels" [1]', "slice 4 item 26"),
    (b'LightSource "point" "rgb I" [1 1 1]', "slice 3"),
    (b'Material "coateddiffuse"', "slice 3"),
    (b'Texture "t" "spectrum" "checkerboard"', "slice 3 item 9"),
    (b'Camera "orthographic"', "slice 4 item 21"),
    (b'LightSource "infinite" "string filename" "sky.exr" '
     b'"point3 portal" [0 0 0  1 0 0  1 1 0  0 1 0]', "slice 3 item 14"),
    (b'Sampler "halton"', "slice 4 item 21"),
    (b'TransformTimes 0 1', "slice 3 item 10"),
    (b'Frobnicate 1 2 3', None),
])
def test_unsupported_directive_raises(snippet, item):
    text = b"WorldBegin\n\n" + snippet + b"\n"
    with pytest.raises(parser.ParseError) as err:
        parser.parse_string(text, fname="x.pbrt", device="cpu")
    msg = str(err.value)
    assert msg.startswith("x.pbrt:3:"), msg
    assert (item is None and "unknown directive" in msg) or \
        f"ROADMAP.md {item}" in msg, msg
