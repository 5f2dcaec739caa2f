"""nice_tpu_torch.parallel — the mesh of slices a field runs on in one
process, and the scheduler's occupancy meter (the port's twin of
nice_tpu/parallel)."""
