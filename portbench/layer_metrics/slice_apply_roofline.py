"""The training slice-apply kernels' share of their roofline: the summed
bounds of a step's K3, K4 and K5 at every level
(``counts.slice_apply_bound_s``) times the traced steps, over those
kernels' summed device time."""

# K3 at 3 -> 3 is the fused kernel with its guide loaded, else the tile
# kernel; K4 the pixel backward; K5 its partial sums and their reduction.
KERNELS = (('enhance_fused_kernel', 'LoadedGuide'), 'slice_apply_fwd_kernel',
           'pix_bwd_fixed_kernel', 'pix_bwd_kernel', 'grid_bwd_partial_kernel',
           'grid_bwd_reduce_kernel')


def read(s):
  hits = s.matching(KERNELS)
  if not hits or not s.work.get('slice_apply_bound_s'):
    return None
  busy = sum(a.end - a.start for a in hits) * 1e-6
  return 100.0 * s.work['slice_apply_bound_s'] * s.iterations / busy
