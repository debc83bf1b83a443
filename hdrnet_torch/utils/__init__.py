"""Helpers of the port: image conversions, dataset metadata and the
import of reference TF checkpoints."""
