"""Helpers of the port: image conversions, dataset metadata, the import
of reference TF checkpoints, and device timing."""
