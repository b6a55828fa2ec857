"""Export the reference's scenes, cameras and samplers to numpy, in the form
pbrt_tpu_torch.convert.from_jax_scene takes (shared by the test_torch_*
files)."""
import numpy as np

from pbrt_tpu import lights as jlgt
from pbrt_tpu import samplers as jsmp
from pbrt_tpu import scenes as jscenes
from pbrt_tpu.ops import megawave as jmw


def export(scene, cam, sampler):
    """(arrays, meta) of a reference Scene, Camera and SamplerParams."""
    ls = scene.light_sampler
    arrays = dict(tri_all=np.asarray(scene.tri_all),
                  mat_pool=np.asarray(scene.materials.packed),
                  lights_packed=np.asarray(scene.lights.packed),
                  spectra_pool=np.asarray(scene.spectra_pool),
                  ls_pmf=np.asarray(ls.pmf_table),
                  c2w_m=np.asarray(cam.c2w_m),
                  tan_half_fov=np.asarray(cam.tan_half_fov))
    if ls.rows is not None:
        arrays["ls_rows"] = np.asarray(ls.rows)
    meta = dict(ls_kind=ls.kind, n_lights=ls.n_lights,
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
