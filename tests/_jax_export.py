"""Export the reference's cornell scene, camera and sampler to numpy, in the
form pbrt_tpu_torch.convert.from_jax_scene takes (shared by the
test_torch_* files)."""
import numpy as np

from pbrt_tpu import samplers as jsmp
from pbrt_tpu import scenes as jscenes
from pbrt_tpu.ops import megawave as jmw


def export_cornell(W=16, H=16, spp=4):
    """Returns (jax scene, jax camera, jax sampler, arrays, meta)."""
    scene, cam = jscenes.make_cornell_box(width=W, height=H)
    sampler = jsmp.make_sampler("zsobol", spp=spp, full_resolution=(W, H))
    attr, light, mat = jmw.scene_tables(scene)
    arrays = dict(tri_pallas=np.asarray(scene.tri_pallas),
                  attr=np.asarray(attr), light=np.asarray(light),
                  mat=np.asarray(mat),
                  spectra_pool=np.asarray(scene.spectra_pool),
                  lights_packed=np.asarray(scene.lights.packed),
                  c2w_m=np.asarray(cam.c2w_m),
                  tan_half_fov=np.asarray(cam.tan_half_fov))
    meta = dict(mega=scene.mega._asdict(), width=cam.width,
                height=cam.height, screen_min=cam.screen_min,
                screen_max=cam.screen_max, has_lens=cam.has_lens,
                seed=sampler.seed, spp=sampler.spp,
                log2_spp=sampler.log2_spp,
                n_base4_digits=sampler.n_base4_digits)
    return scene, cam, sampler, arrays, meta
