"""PyTorch/CUDA port of the PoST main path of ``spacemesh_tpu``.

The package runs label init, proving and verification on one NVIDIA H100
(sm_90a), and the layers above them that the port has reached so far: the
PoST worker, the multi-tenant scheduler, verifyd and its fleet, ATX
validation (the codec, the state database, gossip, the activation
handlers), and the host-side consensus protocols (eligibility, hare,
beacon, the external poet). It imports ``torch`` and never JAX, and
nothing of the JAX package: what it needs from there is copied here. The
card's work runs in CUDA C++ kernels under ``csrc/`` (ROMix, PBKDF2, the
proving scan, k2pow), built by ``nvcc`` at first use (``ops/_build.py``);
the host's hot one-shots (blake3, ECVRF) in C++ under ``native/``, built
by ``g++`` at first use (``native/__init__.py``); everything around them
is plain PyTorch and Python.

u32 values live in ``torch.int32`` tensors as bit patterns
(``ops/u32.py``), with the JAX package's lanes-trailing layouts ((words, B))
at every public function, so the tests compare like with like.

Entry points take ``device=`` and default to ``"cuda"``; only an explicit
``device="cpu"`` runs on the host (``device.py``).
"""
