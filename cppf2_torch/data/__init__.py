"""Training data: procedural meshes, the renderers, the synthetic frame
generator and the record store (counterpart of `cppf2_tpu/data`)."""

from cppf2_torch.data.render import NOCS_INTRINSICS, raster_render_depth, splat_render_depth
from cppf2_torch.data.shapes import load_obj, load_ply, make_category_mesh, sample_surface
from cppf2_torch.data.synthetic import SynthFrame, SyntheticFrameGenerator

__all__ = [
    "make_category_mesh",
    "sample_surface",
    "load_obj",
    "load_ply",
    "splat_render_depth",
    "raster_render_depth",
    "NOCS_INTRINSICS",
    "SyntheticFrameGenerator",
    "SynthFrame",
]
