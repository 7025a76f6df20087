"""Mesh construction and batch-axis padding helpers."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

from lz4jpeg_tpu.config import MeshConfig


def codec_mesh(config: MeshConfig = MeshConfig()) -> Mesh:
    """A 1-D device mesh over the block/MCU data axis.

    Uses all visible devices by default.  Within a host the axis rides the
    device interconnect (NVLink); across hosts (after
    ``jax.distributed.initialize``) ``jax.devices()`` spans the network and
    the same mesh covers the multi-host case — collectives are inserted by
    XLA either way.
    """
    devices = jax.devices()
    n = config.num_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, only {len(devices)} visible")
    return Mesh(np.asarray(devices[:n]), (config.data_axis,))


def pad_to_devices(
    batch: np.ndarray, n_devices: int, pad_value=0
) -> Tuple[np.ndarray, int]:
    """Right-pad the leading (block/MCU) axis to a multiple of the mesh size.

    Returns ``(padded, original_length)``.  Padding rows are masked out after
    the ordered gather — the moral equivalent of the reference's pre-sized
    ``frame_blocks`` array indexed by block id (LZ4.c:708).
    """
    n = batch.shape[0]
    padded_n = -(-n // n_devices) * n_devices
    if padded_n == n:
        return batch, n
    pad_width = [(0, padded_n - n)] + [(0, 0)] * (batch.ndim - 1)
    return np.pad(batch, pad_width, constant_values=pad_value), n


def shard_leading_axis(
    arrays: Sequence[jax.Array], mesh: Mesh, axis_name: Optional[str] = None
):
    """Place each array with its leading axis sharded over the mesh."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    name = axis_name or mesh.axis_names[0]
    sharding = NamedSharding(mesh, P(name))
    return [jax.device_put(a, sharding) for a in arrays]
