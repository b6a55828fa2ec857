"""The reference's many-light samplers (refport/lightsampler_bvh.py, the
light-BVH and exhaustive samplers in refport/lightsamplers.py) against the
program's: the same tables, picks and pmfs, bit for bit on the CPU, and
the same images through checks.Reference and harness.Program. A cell of
a many-light scene then needs only new files."""
import dataclasses
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench import checks, harness, spec
from portbench.refport import lightsampler_bvh as ref_lbvh
from portbench.refport import lightsamplers as ref_ls
from portbench.refport.scene import parser as ref_parser
from pbrt_tpu_torch import lightsamplers as prog_ls
from pbrt_tpu_torch.scene import parser as prog_parser

SCENES = spec.ROOT / "scenes"
TABLES = ("nodes", "bit_trail", "trail_len", "outside", "pmf_outside")
SAMPLERS = ("bvh", "exhaustive")
BVH_LINE = '"string lightsampler" "bvh"'


def scene_file(name, sampler, tmp_path):
    """scenes/<name>.pbrt, whose Integrator asks for the light-BVH sampler,
    or a copy of it in tmp_path that asks for `sampler`."""
    path = SCENES / f"{name}.pbrt"
    if sampler == "bvh":
        return path
    text = path.read_text()
    assert text.count(BVH_LINE) == 1
    out = tmp_path / f"{name}.{sampler}.pbrt"
    out.write_text(text.replace(BVH_LINE, f'"string lightsampler" '
                                          f'"{sampler}"'))
    return out


@pytest.fixture(scope="module", params=["manylight", "manylight16k"])
def both_sides(request):
    """(name, {sampler: (reference's scene, program's scene)}) on the
    CPU."""
    name = request.param
    text = (SCENES / f"{name}.pbrt").read_text()
    out = {}
    for sampler in SAMPLERS:
        t = text.replace(BVH_LINE, f'"string lightsampler" "{sampler}"')
        out[sampler] = tuple(
            side.parse_string(t, base_dir=str(SCENES), device="cpu").scene
            for side in (ref_parser, prog_parser))
    return name, out


def test_light_bvh_tables_are_the_programs(both_sides):
    name, scenes = both_sides
    ref, prog = (s.light_sampler for s in scenes["bvh"])
    assert isinstance(ref, ref_lbvh.BVHLightSampler)
    assert ref.n_lights == prog.n_lights > 1000
    assert (ref.max_depth, ref.p_outside) == (prog.max_depth, prog.p_outside)
    for k in TABLES:
        a, b = getattr(ref, k), getattr(prog, k)
        assert a.dtype == b.dtype and torch.equal(a, b), k
    # the pool's pmf column is uniform under a position-aware sampler
    for ref_scene, prog_scene in scenes.values():
        assert torch.equal(ref_scene.lights_packed, prog_scene.lights_packed)
        assert ref_scene.alias_rows is None


def shading_points(n, seed):
    """Seeded points inside the many-light scenes' room (x -10..10, y
    0..8, z -10..14), unit normals and picks."""
    g = torch.Generator().manual_seed(seed)
    p = torch.rand((n, 3), generator=g) * torch.tensor([19.8, 7.8, 23.8]) \
        - torch.tensor([9.9, -0.1, 9.9])
    nrm = torch.randn((n, 3), generator=g)
    nrm = nrm / nrm.norm(dim=1, keepdim=True)
    u = torch.rand((n,), generator=g)
    return p, nrm, u


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_picks_and_pmfs_are_the_programs(both_sides, sampler):
    """sample_light and light_pmf, bit for bit the program's, with and
    without the receivers' normals; light_pmf gives each sampled light the
    pmf that sample_light returned."""
    name, scenes = both_sides
    ref, prog = (s.light_sampler for s in scenes[sampler])
    assert ref_ls.positional(ref) and ref.kind == prog.kind
    n = 512 if name == "manylight16k" and sampler == "exhaustive" else 4096
    p, nrm, u = shading_points(n, 16)
    for n_ref in (None, nrm):
        li, pmf = ref_ls.sample_light(ref, u, p=p, n_ref=n_ref)
        li_p, pmf_p = prog_ls.sample_light(prog, u, p=p, n_ref=n_ref)
        assert torch.equal(li, li_p) and torch.equal(pmf, pmf_p)
        assert (li >= 0).all() and (li < ref.n_lights).all()
        # the panels at y = 6 emit upward: the exhaustive sampler finds
        # nothing to pick below them (pmf 0), the BVH walk still descends
        assert (pmf > 0).sum() > n // 5 and len(torch.unique(li)) > 100
        again = ref_ls.light_pmf(ref, li, p=p, n_ref=n_ref)
        assert torch.equal(again, prog_ls.light_pmf(prog, li, p=p,
                                                    n_ref=n_ref))
        assert torch.equal(again, pmf)
        other = torch.randint(0, ref.n_lights, (n,),
                              generator=torch.Generator().manual_seed(5))
        assert torch.equal(ref_ls.light_pmf(ref, other, p=p, n_ref=n_ref),
                           prog_ls.light_pmf(prog, other, p=p, n_ref=n_ref))


def manylight_cell(scene_path, size=16, spp=4, rows=None, height=None):
    """A cell of `scene_path`, made from a loaded cell as
    test_portbench_check.tiny() makes its crops: depth 3 as in the scene
    file, killeroo's reference limits, no golden; rows: reference_rows."""
    cell = spec.load_cell("killeroo.200x200")
    limits = {k: v for k, v in cell.workload.limits.items()
              if k != "golden_mrse"}
    wl = dataclasses.replace(
        cell.workload, config=scene_path.stem, traffic=f"{size}x{size}",
        width=size, height=height or size, spp=spp, max_depth=3,
        limits=limits, golden=None, golden_trim=0.0, golden_window=None,
        reference_rows=rows)
    return dataclasses.replace(cell, name=f"{scene_path.stem}.crop",
                               scene_path=scene_path, workload=wl,
                               end_to_end=(), per_layer=())


def reference_of(cell):
    wl = cell.workload
    return checks.Reference(spec.scene_text(cell, wl), cell.scene_path.parent,
                            wl, "cpu")


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_manylight_renders_as_the_program(sampler, tmp_path):
    """manylight at 16x16, 4 spp, depth 3: checks.Reference's image is
    harness.Program's, bit for bit, under either sampler."""
    cell = manylight_cell(scene_file("manylight", sampler, tmp_path))
    program = harness.Program(cell, "cpu", seed=7)
    assert program.desc.scene.light_sampler.kind == \
        {"bvh": prog_ls.LS_BVH, "exhaustive": prog_ls.LS_EXHAUSTIVE}[sampler]
    s = checks.image_seed(7, 0)
    got, stats = program.render(s)
    assert stats["spp"] == 4
    ref = reference_of(cell).render(s)
    assert ref.mean() > 0 and np.array_equal(got, ref)
    assert all(v == 0 for v in checks.compare(got, ref).values())


def test_manylight16k_sampled_rows_render_as_the_program():
    """A few rows of a manylight16k crop (17,100 triangles: the BVH8
    route), rendered by the reference alone, are the program's rows."""
    cell = manylight_cell(SCENES / "manylight16k.pbrt", size=20, rows=3,
                          height=12)
    wl = cell.workload
    s = checks.image_seed(9, 0)
    got, _ = harness.Program(cell, "cpu", seed=9).render(s)
    rows = checks.sample_rows(9, 0, wl.height, wl.reference_rows)
    part = reference_of(cell).render(s, rows)
    assert part.shape == (3, 20, 3) and part.mean() > 0
    assert np.array_equal(part, got[rows])


@pytest.mark.parametrize("text, words", [
    ('WorldBegin\nShape "sphere" "float radius" [1]\n', "shape 'sphere'"),
    ('WorldBegin\nObjectBegin "a"\nObjectEnd\n', "directive 'ObjectBegin'"),
])
def test_reference_still_refuses(text, words):
    with pytest.raises(ref_parser.ParseError, match=words):
        ref_parser.parse_string(text, device="cpu")


def test_position_aware_sampler_with_an_infinite_light_is_refused():
    """As the program does, with the same words."""
    text = ('Integrator "path" "string lightsampler" "bvh"\nWorldBegin\n'
            'LightSource "infinite" "rgb L" [1 1 1]\n'
            'AttributeBegin\nAreaLightSource "diffuse" "rgb L" [1 1 1]\n'
            'Shape "trianglemesh" "integer indices" [0 1 2] '
            '"point3 P" [0 0 0 1 0 0 0 1 0]\nAttributeEnd\n')
    words = []
    for side in (ref_parser, prog_parser):
        with pytest.raises(NotImplementedError) as e:
            side.parse_string(text, device="cpu")
        words.append(str(e.value))
    assert words[0] == words[1] and "infinite light" in words[0]


IMPORTS = """
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import portbench.refport as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from portbench.refport.scene import parser
parser.parse_string(open({scene!r}).read(), base_dir={base!r}, device="cpu")
print(sorted({{m.split(".")[0] for m in sys.modules}}
             & {{"pbrt_tpu_torch", "pbrt_tpu", "jax", "jaxlib", "flax"}}))
"""


def test_reference_imports_nothing_of_the_program_or_jax():
    """Every module of the reference imported and a many-light scene
    parsed, in a process of its own: neither the program, the JAX package
    nor JAX is loaded."""
    code = IMPORTS.format(root=str(spec.ROOT),
                          scene=str(SCENES / "manylight.pbrt"),
                          base=str(SCENES))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.cuda
def test_manylight16k_on_the_card(card):
    """manylight16k at its scene file's size (200x200, 32 spp, depth 3) on
    the card: the program's image within killeroo's reference limits of
    checks.Reference's, and within 0.1 of pbrt-v4's render by golden_mrse.
    Prints the times and the peak memory that a cell would start from."""
    cell = manylight_cell(SCENES / "manylight16k.pbrt", size=200, spp=32)
    wl = cell.workload
    seed = 2 ** 31 + 1616
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    program = harness.Program(cell, "cuda", seed)
    setup_s = time.perf_counter() - t
    s = checks.image_seed(seed, 0)
    times = []
    for _ in range(3):
        t = time.perf_counter()
        img, _ = program.render(s)
        times.append(time.perf_counter() - t)
    program_peak = torch.cuda.max_memory_allocated()
    program.close()
    t = time.perf_counter()
    ref = checks.Reference(spec.scene_text(cell, wl), cell.scene_path.parent,
                           wl, "cuda")
    torch.cuda.synchronize()
    ref_parse_s = time.perf_counter() - t
    t = time.perf_counter()
    ref_img = ref.render(s)
    ref_image_s = time.perf_counter() - t
    golden = checks.read_golden(spec.ROOT / "goldens" /
                                "manylight16k_200_32spp.exr")
    numbers = checks.compare(img, ref_img, golden, 0.0)
    image_s = float(np.median(times))
    print(f"manylight16k on {torch.cuda.get_device_name(0)}: {numbers}; "
          f"program set-up {setup_s:.3f} s, images {times} s, "
          f"{wl.paths / image_s:.6g} paths/s, peak {program_peak} B; "
          f"reference parse {ref_parse_s:.3f} s, image {ref_image_s:.3f} s, "
          f"peak {torch.cuda.max_memory_allocated()} B")
    assert checks.within(numbers, dict(wl.limits, golden_mrse=0.1))
