"""Training over several processes on a ('data', 'spatial') mesh
(counterpart of ``hdrnet_tpu.parallel``): :mod:`.mesh` and
:mod:`.collectives`."""
