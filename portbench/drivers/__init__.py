"""Drivers, one per kind of traffic: ``run(spec, seed, seconds, trace,
device, t_start)``."""
