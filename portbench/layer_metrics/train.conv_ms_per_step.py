"""Device ms a step of cuDNN's convolution kernels: forward, data
gradient and weight gradient, with the layout transposes and scalings
cuDNN launches inside those calls. In the feature-pyramid cell they are
the three full-resolution towers' and the coefficient backbone's
convolutions (no other op of its step calls cuDNN)."""

# Words of the kernels' names in the traced kernel list on an NVIDIA H100
# (float32, TF32 off): convolve_common_engine_float_NHWC and
# sm80_xmma_fprop_implicit_gemm (forward), cudnn::detail::dgrad_engine
# and sm80_xmma_dgrad_implicit_gemm (data gradient), wgrad_alg0_engine_NHWC
# and sm80_xmma_wgrad_implicit_gemm_indexed (weight gradient), and
# cudnn::engines_precompiled's nchwToNhwcKernel, nhwcToNchwKernel and
# scalePackedTensor_kernel.
KERNELS = ('convolve_common_engine', 'fprop', 'dgrad', 'wgrad',
           'cudnn::engines_precompiled')


def read(s):
  hits = s.matching(KERNELS)
  if not hits:
    return None
  return sum(a.end - a.start for a in hits) * 1e-3 / s.iterations
