"""nice_tpu_torch.parallel — device-level accounting shared by the
scheduler (the port's cut of nice_tpu/parallel: one device, so only the
occupancy meter for now)."""
