"""Training over several processes on a ('data', 'spatial') mesh
(counterpart of ``hdrnet_tpu.parallel``): :mod:`.mesh`,
:mod:`.collectives` and :mod:`.halo` (the H-bands' halo exchange)."""
