"""Multi-host startup and cross-host ordered gather.

The reference's world is one process with shared memory; its "gather" is
``frame_blocks[index] = *block`` under a critical section
(``Algorithms/parallel/LZ4/LZ4.c:495-514``).  Across hosts the collective
equivalents are:

* ``initialize()`` — ``jax.distributed.initialize`` when launched with
  coordinator/process env (a no-op single-process, so the same code runs
  everywhere);
* ``ordered_allgather_payloads`` — gather variable-length byte payloads
  (compressed blocks) from every process in original block order, with the
  standard pad + length-side-channel treatment for ragged data
  (SURVEY.md §5 "Distributed communication backend").
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Bring up the multi-process JAX runtime; returns the process count.

    With no arguments it initializes from cluster env vars when present and
    degrades to single-process otherwise — the same entry point works in
    tests, on one host and on an N-host slice.
    """
    import jax

    if coordinator_address is None and num_processes is None:
        return jax.process_count()
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_count()


def ordered_allgather_payloads(
    local_payloads: List[bytes],
    local_indices: List[int],
    total_count: int,
) -> List[bytes]:
    """Gather per-block byte payloads from all processes, ordered by their
    original block index.

    Each process holds the payloads of the blocks it encoded (its shard of
    the block axis) plus their global indices.  Payloads are padded to the
    global max length, all-gathered together with (index, length) side
    channels, and reassembled in index order — the collective version of
    the reference's pre-sized ordered gather array.
    """
    import jax

    max_len = max((len(p) for p in local_payloads), default=0)
    from jax.experimental import multihost_utils

    if jax.process_count() > 1:
        # Payload width must be identical on every process for the
        # allgather; take the global maximum first.
        max_len = int(
            multihost_utils.process_allgather(np.asarray([max_len])).max()
        )
    local_n = len(local_payloads)
    padded = np.zeros((local_n, max(max_len, 1)), np.uint8)
    meta = np.zeros((local_n, 2), np.int64)  # (global index, length)
    for i, (payload, gi) in enumerate(zip(local_payloads, local_indices)):
        padded[i, : len(payload)] = np.frombuffer(payload, np.uint8)
        meta[i] = (gi, len(payload))

    if jax.process_count() == 1:
        gathered_data, gathered_meta = padded, meta
    else:
        # process_allgather concatenates along a new leading axis; ragged
        # per-process counts are handled by padding to the max count first.
        counts = multihost_utils.process_allgather(np.asarray([local_n]))
        max_n = int(counts.max())
        pad_rows = max_n - local_n
        if pad_rows:
            padded = np.pad(padded, ((0, pad_rows), (0, 0)))
            meta = np.pad(
                meta, ((0, pad_rows), (0, 0)), constant_values=-1
            )
        gathered_data = multihost_utils.process_allgather(padded).reshape(
            -1, padded.shape[1]
        )
        gathered_meta = multihost_utils.process_allgather(meta).reshape(-1, 2)

    out: List[Optional[bytes]] = [None] * total_count
    for row, (gi, length) in zip(gathered_data, gathered_meta):
        if gi < 0:
            continue  # padding row
        out[int(gi)] = bytes(row[: int(length)])
    missing = [i for i, p in enumerate(out) if p is None]
    if missing:
        raise ValueError(f"blocks missing after gather: {missing[:5]}")
    return out  # type: ignore[return-value]
