"""Device ms a step of K4's launches that also write the image's
cotangent: the slice-apply's pixel backward where the sliced image is
learned (in the stacked model, stage 2's image, stage 1's output). Beside
``slice_apply_roofline``, which holds every slice kernel, it shows
whether this path sets the pace."""

# Words of the kernel's name in the traced kernel list on an NVIDIA H100:
# K4 at 3 -> 3 is pix_bwd_fixed_kernel<kNeedInput, kStaged>, and
# kNeedInput true is the instantiation that writes d_image
# ("pix_bwd_fixed_kernel<true, true>", "<true, false>" where the tile's
# window is read from device memory). The generic pix_bwd_kernel's
# template arguments are <kSlice, kStaged>: whether it writes d_image is
# a null pointer at run time, so its name cannot tell, and it is not read.
KERNELS = ('pix_bwd_fixed_kernel<true',)


def read(s):
  hits = s.matching(KERNELS)
  if not hits:
    return None
  return sum(a.end - a.start for a in hits) * 1e-3 / s.iterations
