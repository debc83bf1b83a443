"""hdrnet_torch: the PyTorch / CUDA port of hdrnet_tpu for NVIDIA Hopper.

The serving path of ``HDRNetCurves`` (``hdrnet_torch.inference``) runs on
two hand-written CUDA kernels in ``csrc/``: the preview downsample and the
fused curves guide + slice + apply. The JAX package ``hdrnet_tpu`` is the
reference the port is tested against; this package never imports JAX.
"""

__version__ = '0.1.0'
