"""Node composition (port of ``spacemesh_tpu/node/``): config, presets,
clock, events and the App wiring.

All cross-component wiring happens in ``app.py`` (reference node/node.go
App + config/), nowhere else.
"""
