"""The benchmark of ``hdrnet_torch`` on the card (``python -m portbench.run``)."""
