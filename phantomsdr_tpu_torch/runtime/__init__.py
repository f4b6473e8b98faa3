"""Host runtime: sample driver, registries and the serving edge."""
