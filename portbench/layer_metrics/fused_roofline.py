"""The fused guide + slice + apply kernels' share of their roofline: the
summed bounds of a frame's launches (``counts.fused_bound_s``: K1 on the
uint8 frame, or K6 on each pyramid level) times the traced frames, over
the kernels' summed device time."""

# The kernel's guide functors: K1 curves, K6 NN (K3 loads its guide).
KERNELS = (('enhance_fused_kernel', 'CurvesGuide'),
           ('enhance_fused_kernel', 'NNGuide'))


def read(s):
  hits = s.matching(KERNELS)
  if not hits or not s.work.get('fused_bound_s'):
    return None
  busy = sum(a.end - a.start for a in hits) * 1e-6
  return 100.0 * s.work['fused_bound_s'] * s.iterations / busy
