"""Three port nodes in separate OS processes over real TCP sockets, one
SIGKILLed mid-run: the cases of ``tests/test_process_net.py`` on the port
through ``torch_twin`` (tier-2, ``slow``, as the JAX file is; the nodes
run ``python -m spacemesh_tpu_torch.node ... --device cpu``).
"""

import pytest

from torch_twin import export

pytestmark = pytest.mark.slow

export("test_process_net", globals())
