"""The port's consensus under a shuffled scheduler: the case of
``tests/test_schedule_fuzz.py`` runs on the port through ``torch_twin``.
Two smeshers (``App(device="cpu")``) on the port's ``ChaosClockLoop``,
whose ready queue is shuffled from a seed, must converge at each seed.
"""

from torch_twin import export

export("test_schedule_fuzz", globals())
