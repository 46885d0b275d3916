from cp360_tpu_torch.geometry.equi_cube import (  # noqa: F401
    build_cube2equi_map,
    build_equi2cube_maps,
)
