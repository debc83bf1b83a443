"""Device ms a frame of torch's own kernels (``at::native``) and of the
pyramid's level kernels (``pyramid_down_kernel``, ``pyramid_up_add_kernel``)
in the traced stretch. In the pyramid stream that is the level work: the
levels, the coarse-to-fine sum, the clip and the requantize, whether ATen
or the level kernels run them. It also counts the backbone's few ATen
kernels (its bias adds and activations, about 0.05 ms a 4K frame), which
are all it reads in the curves stream, the control."""

KERNELS = ('at::native', 'pyramid_down_kernel', 'pyramid_up_add_kernel')


def read(s):
  hits = s.matching(KERNELS)
  if not hits:
    return None
  return sum(a.end - a.start for a in hits) * 1e-3 / s.iterations
