"""Host utilities of the port: atomic state-file writes (fsio) and the
daemon's CPU sampler (resources)."""
