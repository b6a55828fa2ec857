"""Built-in scene models (counterpart of pbrt_tpu/models): re-exports of
pbrt_tpu_torch.scenes under the reference's names.

- cornell_box        — the main path's scene
- material_showcase  — exact spheres: conductors and a dielectric under an
  environment map
- furnace_plane / furnace_sphere — analytic correctness oracles
"""
from ..scenes import (  # noqa: F401
    make_cornell_box as cornell_box,
    make_material_showcase as material_showcase,
    make_furnace_plane as furnace_plane,
    make_furnace_sphere as furnace_sphere,
    make_sphere_mesh,
)
