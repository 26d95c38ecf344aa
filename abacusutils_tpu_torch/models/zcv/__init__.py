"""Zel'dovich control variates (ZCV): the IC bias fields, their advection and
spectra, the window and ZeNBu templates, and the k-level reduction."""
