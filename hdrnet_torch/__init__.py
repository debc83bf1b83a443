"""hdrnet_torch: the PyTorch / CUDA port of hdrnet_tpu for NVIDIA Hopper.

The three HDRNet models (``HDRNetCurves``, ``HDRNetPointwiseNNGuide``,
``HDRNetGaussianPyrNN``) serve (``hdrnet_torch.inference``) on
hand-written CUDA kernels in ``csrc/``: the preview downsample and the
fused guide + slice + apply, with the curves guide or the NN guide; and
train (``hdrnet_torch.training``, ``python -m hdrnet_torch.bin.train``)
on three more: the slice-apply with an external guide and its two
backward passes, on one card or over several processes on a ('data',
'spatial') mesh (``hdrnet_torch.parallel``; the slice-apply kernels take
a rank's H-band of a frame, and ``parallel.halo`` exchanges the rows of
the neighbouring bands that the resizes and convolutions read). The
tools (``bin/export.py`` over the registered ``hdrnet::`` ops,
``fit_grid``, ``viz_activations``,
``compare_baselines``, ``utils/``) and the round-4 downsample experiment
with its tensor-core kernel K2x (``scripts/``) are ported too. The JAX
package
``hdrnet_tpu`` is the reference the port is tested against; this package
never imports JAX.
"""

__version__ = '0.1.0'
