"""Plain reference of SEARS's data plane: NumPy and ``hashlib`` only.

Frozen copies of the rules the store under test implements, kept apart
from it so that a change to the program cannot move the yardstick:

* ``cdc``: the gear rolling hash and the greedy min / max boundary rule;
* ``ids``: SHA-1 chunk ids;
* ``rs``: GF(2^8) (polynomial 0x11D) and the systematic Cauchy
  Reed-Solomon (n, k) code, encode and decode from any k pieces.

Nothing here imports the program (``repro_torch``), the JAX package or
JAX; everything is worked out again from the bytes the harness made.
"""
