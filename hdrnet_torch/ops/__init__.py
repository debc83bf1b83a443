"""Bilateral-grid ops and the serving kernels (imported lazily: importing
this package builds nothing)."""
