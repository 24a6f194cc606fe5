"""Static analysis of the port's execution plans (the counterpart of
``repro.analysis``). Only :func:`audit.fused_site_geometries` is here so
far; it is what ``repro_torch.tune.workloads`` prices."""
