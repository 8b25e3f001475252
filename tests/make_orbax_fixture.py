"""The small orbax checkpoint the port's reader is held to on the card,
``tests/data/jax_orbax_small/``, and the SHA-256 of each of its leaves,
``tests/data/jax_orbax_small.sha256.json``.

The checkpoint is written by the JAX package's own ``save_checkpoint``
(orbax's OCDBT store of zarr v2 leaves, zstd-compressed): the one
JAX-written store that reaches the card, which has no JAX. Its tree has
nested dicts, an optax-style state (a tuple, so ``'0'`` / ``'1'`` keys),
float32, bfloat16 and int32 leaves, scalars, a leaf under and one over the
store's 1,024-byte inline limit, an all-zero leaf, a leaf of incompressible
floats (zstd's Huffman literals) and a repetitive one (its FSE-coded
sequences). The leaves are drawn from a seed; the store's files carry a
random id and timestamps, so the CPU test compares leaves, not files.

Rewrite both with ``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/make_orbax_fixture.py``.
"""

import hashlib
import json
import shutil
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
FIXTURE = HERE / "data" / "jax_orbax_small"
SHA256 = HERE / "data" / "jax_orbax_small.sha256.json"
STEP = 1


def fixture_tree():
    """The fixture's tree, numpy only (bfloat16 leaves as float32 here;
    :func:`write_fixture` casts them)."""
    rng = np.random.RandomState(16)
    motif = rng.randn(37).astype(np.float32)
    return {
        "params": {
            "conv": {"kernel": (rng.randn(3, 3, 4, 8) * 0.1).astype(np.float32),  # 1,152 B
                     "bias": rng.randn(8).astype(np.float32)},  # inline
            "dense": {"kernel": rng.randn(6, 5).astype(np.float32)},
        },
        "opt": ({"count": np.int32(7), "mu": {"w": np.zeros((64, 32), np.float32)}},
                {"count": np.int32(7)}),
        "noise": rng.standard_normal(4096).astype(np.float32),
        "tiled": _tiled(motif, rng),
        "bf16": {"table": rng.randn(16, 24).astype(np.float32)},
        "ids": rng.randint(-1000, 1000, size=(5, 7)).astype(np.int32),
        "scale": np.float32(0.25),
    }


def _tiled(motif, rng):
    """A motif repeated with scattered changes: zstd codes its matches as
    sequences."""
    out = np.tile(motif, 120)
    hit = rng.randint(0, out.size, size=300)
    out[hit] += rng.randn(300).astype(np.float32)
    return out


def _bf16_paths():
    return {("bf16", "table")}


def leaf_hashes(flat):
    """{path: {"sha256", "dtype", "shape"}} of ``(path tuple, array)``
    pairs; bfloat16 leaves hash their bits as little-endian uint16."""
    out = {}
    for path, arr in flat:
        dtype = "bfloat16" if path in _bf16_paths() else np.dtype(arr.dtype).str
        out["/".join(path)] = {"sha256": hashlib.sha256(np.ascontiguousarray(arr).tobytes())
                               .hexdigest(), "dtype": dtype, "shape": list(np.shape(arr))}
    return dict(sorted(out.items()))


def flatten(tree, path=()):
    """(path tuple, leaf) pairs, dict keys and sequence indices as strings."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in flatten(v, path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in flatten(v, path + (str(i),))]
    return [(path, tree)]


def expected_hashes():
    """The leaf hashes of :func:`fixture_tree` as the checkpoint holds them."""
    import torch

    flat = []
    for path, leaf in flatten(fixture_tree()):
        if path in _bf16_paths():
            leaf = torch.from_numpy(leaf).to(torch.bfloat16).view(torch.uint16).numpy()
        flat.append((path, np.asarray(leaf)))
    return leaf_hashes(flat)


def write_fixture(dest):
    """Write the checkpoint with the JAX package's ``save_checkpoint`` as
    step :data:`STEP` of ``dest``."""
    import jax.numpy as jnp

    from tecogan_tpu.train.checkpoint import save_checkpoint

    def to_jax(tree, path=()):
        if isinstance(tree, dict):
            return {k: to_jax(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(to_jax(v, path + (str(i),)) for i, v in enumerate(tree))
        arr = jnp.asarray(tree)
        return arr.astype(jnp.bfloat16) if path in _bf16_paths() else arr

    save_checkpoint(str(dest), to_jax(fixture_tree()), STEP)


if __name__ == "__main__":
    shutil.rmtree(FIXTURE, ignore_errors=True)
    write_fixture(FIXTURE)
    SHA256.write_text(json.dumps({"step": STEP, "leaves": expected_hashes()}, indent=1) + "\n")
    print(f"wrote {FIXTURE} and {SHA256}")
