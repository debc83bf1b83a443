"""Bilateral-grid ops and the serving kernels. Importing this package
registers the ``hdrnet::`` ops that exported graphs call
(``nearest_lowres``, ``enhance_fused``, ``slice_apply_fwd``,
``resize_bilinear``) and builds nothing: the kernels are built at their
first launch."""

from hdrnet_torch.ops import downsample, fused, levels, resize, slice_apply

__all__ = ['downsample', 'fused', 'levels', 'resize', 'slice_apply']
