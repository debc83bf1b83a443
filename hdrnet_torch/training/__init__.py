"""Training of the port on one device (counterpart of ``hdrnet_tpu.training``)."""
