"""Model math of the port: every family of the registry, tensor-parallel
(simulated model axis, :mod:`repro_torch.models.tp`) but for the SSM
layers, which run at tp=1."""
