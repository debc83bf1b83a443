"""hdrnet_torch: the PyTorch / CUDA port of hdrnet_tpu for NVIDIA Hopper.

The three HDRNet models (``HDRNetCurves``, ``HDRNetPointwiseNNGuide``,
``HDRNetGaussianPyrNN``) serve (``hdrnet_torch.inference``) on
hand-written CUDA kernels in ``csrc/``: the preview downsample and the
fused guide + slice + apply, with the curves guide or the NN guide; and
train (``hdrnet_torch.training``, ``python -m hdrnet_torch.bin.train``)
on three more: the slice-apply with an external guide and its two
backward passes. The JAX package
``hdrnet_tpu`` is the reference the port is tested against; this package
never imports JAX.
"""

__version__ = '0.1.0'
