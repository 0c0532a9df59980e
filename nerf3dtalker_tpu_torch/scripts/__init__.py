"""Artifact scripts of the port: `python -m nerf3dtalker_tpu_torch.scripts.<name>`."""
