"""Seeds derived from the run's ``--seed`` for each thing drawn from it, so
that one seed gives the same inputs, weights and samples every time."""

import hashlib


def derive(seed: int, tag: str) -> int:
    """A 31-bit seed for ``tag`` under ``seed`` (any whole number)."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:4], "little") & 0x7FFFFFFF
