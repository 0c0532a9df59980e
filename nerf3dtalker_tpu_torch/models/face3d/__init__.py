"""3D face models of the PyTorch port: the mesh rasterizer, the nonlinear
3DMM with its SH shading, and the BFM09 parametric model."""
from nerf3dtalker_tpu_torch.models.face3d.rasterizer import (  # noqa: F401
    rasterize_mesh,
    render_mesh,
)
