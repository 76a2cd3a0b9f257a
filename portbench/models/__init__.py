"""Adapters of the port's models: one module per model kind, with ``build(config,
traffic, seed, device)`` giving a job that sets up, calls, counts its work
and checks its outputs against the plain reference."""
