"""Multi-device mesh construction for the compression pipeline.

The reference's entire parallelism surface is OpenMP loops + parallel sorts
(SURVEY.md §2.8). The device equivalent lives in the production kernels
themselves: `overlap.greedy_scs.find_overlaps(mesh=)` runs the overlap rounds
sharded (per-round id/hash tables merged with collectives) and
`align.matcher.match_reads(mesh=)` shards reads data-parallel over a
replicated pg index. `archive.encoder.encode(mesh=)` threads one mesh through
every device stage, so encoder, dryrun, and tests all exercise the same code
path. This module only builds the mesh.
"""
from __future__ import annotations

import numpy as np


def make_mesh(n_devices: int | None = None):
    """A 1-D device mesh over axis "data". The cards of one host are joined
    all to all, so the mesh follows the algorithm alone."""
    from jax.sharding import Mesh

    from ..device import jax_modules

    jax, _ = jax_modules()
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"mesh of {n_devices} devices asked for, {len(devs)} present")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), axis_names=("data",))
