"""The port's primitives (``spacemesh_tpu_torch/core/{codec,hashing,
signing,types}.py``): the cases of ``tests/test_core.py`` run on the port
through ``torch_twin``. The byte-for-byte comparisons with the JAX
package's primitives are in ``tests/test_torch_codec_types.py`` and
``tests/test_torch_signing.py``.
"""

from torch_twin import export

export("test_core", globals())
