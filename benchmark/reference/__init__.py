"""The plain reference the benchmark judges the program by.

Written from the PoST definitions alone, beside the program and not from
it: a label is ``scrypt(commitment, le64(index), N, r=1, p=1)`` truncated
to 16 bytes (the standard library's ``hashlib.scrypt``), the proving hash
is one Salsa20/8 over the challenge, nonce, index and label (plain PyTorch
integer ops), the threshold is ``k1 * 2^32 / total_labels``, the k2pow
witness is the smallest nonce whose SHA-256 (``hashlib.sha256``) lies below
the difficulty, and the VRF nonce is the index of the smallest label
(NumPy). Nothing here imports the program, ``jax`` or the JAX
package; ``benchmark/tests/test_bench_imports.py`` holds that.
"""
