"""Export the reference's scenes, cameras and samplers to numpy, in the form
pbrt_tpu_torch.convert.from_jax_scene takes (shared by the test_torch_*
files)."""
import contextlib

import numpy as np

from pbrt_tpu import lights as jlgt
from pbrt_tpu import lightsamplers as jls
from pbrt_tpu import samplers as jsmp
from pbrt_tpu import scene_core as jsc
from pbrt_tpu import scenes as jscenes
from pbrt_tpu.ops import megawave as jmw


def export(scene, cam, sampler):
    """(arrays, meta) of a reference Scene, Camera and SamplerParams."""
    ls = scene.light_sampler
    tex = scene.textures
    arrays = dict(tri_all=np.asarray(scene.tri_all),
                  mat_pool=np.asarray(scene.materials.packed),
                  lights_packed=np.asarray(scene.lights.packed),
                  spectra_pool=np.asarray(scene.spectra_pool),
                  tex_desc=np.asarray(tex.desc),
                  tex_atlas=np.asarray(tex.atlas),
                  tex_mips=np.asarray(tex.mips),
                  c2w_m=np.asarray(cam.c2w_m),
                  tan_half_fov=np.asarray(cam.tan_half_fov))
    ls_meta = {}
    if ls.kind == jls.LS_BVH:
        arrays.update(ls_nodes=np.asarray(ls.nodes),
                      ls_bit_trail=np.asarray(ls.bit_trail),
                      ls_trail_len=np.asarray(ls.trail_len),
                      ls_outside=np.asarray(ls.outside),
                      ls_pmf_outside=np.asarray(ls.pmf_outside))
        ls_meta = dict(max_depth=ls.max_depth, p_outside=ls.p_outside)
    elif ls.kind == jls.LS_EXHAUSTIVE:
        arrays.update(ls_cols=np.asarray(ls.cols),
                      ls_is_inf=np.asarray(ls.is_inf))
        ls_meta = dict(p_infinite=ls.p_infinite)
    else:
        arrays["ls_pmf"] = np.asarray(ls.pmf_table)
        if ls.rows is not None:
            arrays["ls_rows"] = np.asarray(ls.rows)
    meta = dict(ls_kind=ls.kind, n_lights=ls.n_lights, ls=ls_meta,
                has_textures=bool(scene.materials.has_textures),
                tex_flags=(bool(tex.has_image), bool(tex.has_mips)),
                scene_radius=float(scene.scene_radius),
                inf_indices=scene.inf_indices,
                light_tags=tuple(t for t in scene.lights.tags_present
                                 if t != jlgt.LIGHT_NONE),
                n_tris=int(scene.tri_geo.shape[0]), mega=None,
                bxdf_tags=tuple(scene.materials.bxdf_tags_present),
                width=cam.width, height=cam.height,
                screen_min=cam.screen_min, screen_max=cam.screen_max,
                has_lens=cam.has_lens, seed=sampler.seed, spp=sampler.spp,
                log2_spp=sampler.log2_spp,
                n_base4_digits=sampler.n_base4_digits)
    if scene.has_curves:
        arrays.update(curve_nodes=np.asarray(scene.curve_nodes),
                      curve_segs=np.asarray(scene.curve_segs),
                      curve_mats=np.asarray(scene.curve_mats))
    if scene.has_blps:
        arrays["blp_rows"] = np.asarray(scene.blp_rows)
    if scene.env is not None:
        env = scene.env
        arrays.update(env_texels=np.asarray(env.texels),
                      env_alias_rows=np.asarray(env.alias_rows),
                      env_pmf=np.asarray(env.pmf),
                      env_illum=np.asarray(env.illum))
        meta["env"] = dict(scale=float(env.scale), width=env.width,
                           height=env.height, light_index=env.light_index)
    if scene.has_instances:
        arrays.update(tlas_nodes=np.asarray(scene.tlas_nodes),
                      inst_rows=np.asarray(scene.inst_rows),
                      tri_geo_tlas=np.asarray(scene.tri_geo_tlas))
        meta["tlas_root"] = scene.tlas_root
    elif scene.bvh8 is not None:
        b8 = scene.bvh8
        arrays.update(nodes_f=np.asarray(b8.nodes_f),
                      nodes_q=np.asarray(b8.nodes_q),
                      tris_b8=np.asarray(b8.tris),
                      prim_indices=np.asarray(b8.prim_indices))
        meta["bvh8"] = (b8.n_nodes, b8.n_tris, b8.depth)
    else:
        arrays["tri_pallas"] = np.asarray(scene.tri_pallas)
    if scene.mega is not None:
        attr, light, mat = jmw.scene_tables(scene)
        arrays.update(attr=np.asarray(attr), light=np.asarray(light),
                      mat=np.asarray(mat))
        meta["mega"] = scene.mega._asdict()
    return arrays, meta


def export_cornell(W=16, H=16, spp=4):
    """Returns (jax scene, jax camera, jax sampler, arrays, meta)."""
    scene, cam = jscenes.make_cornell_box(width=W, height=H)
    sampler = jsmp.make_sampler("zsobol", spp=spp, full_resolution=(W, H))
    arrays, meta = export(scene, cam, sampler)
    return scene, cam, sampler, arrays, meta


@contextlib.contextmanager
def reference_keeps_spectra():
    """Keep every spectrum the reference's SceneBuilder.add_spectrum sees
    alive while the block runs. Its cache keys on id() of spectra that the
    parser frees, so a later spectrum at a reused address can take a stale
    pool row (ROADMAP.md section 3); alive, each id names one spectrum, as
    the port's builder keeps them."""
    orig = jsc.SceneBuilder.add_spectrum
    kept = []

    def add_spectrum(self, s, key=None):
        kept.append(s)
        return orig(self, s, key)
    jsc.SceneBuilder.add_spectrum = add_spectrum
    try:
        yield
    finally:
        jsc.SceneBuilder.add_spectrum = orig
