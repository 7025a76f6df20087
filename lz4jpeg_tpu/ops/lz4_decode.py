"""LZ4 decode on the device: vectorized literal placement + log-depth match copy.

The reference decodes serially: literals appended, then each match byte
copied one at a time against the global output buffer
(``interpret_sequence``, LZ4.c:937-982) — an inherently sequential chain
when matches overlap (offset < length).  The device formulation turns the
whole reconstruction into data-parallel passes (SURVEY.md §7 step 4):

1. host framing scan (cheap, linear) produces a *copy program*: for every
   output position either its literal byte or the index it copies from —
   exactly the reference's global-buffer semantics;
2. literals land with one vectorized scatter;
3. match chains resolve by **pointer doubling**: ``src[i] ← src[src[i]]``
   until every position roots at a literal — ⌈log₂ max_chain⌉ batched
   gathers instead of a byte-serial walk.  A run of length L copied at
   offset 1 (the worst case) resolves in log₂ L steps, not L.

Blocks stay independent on the wire, so the framing scan could itself be
sharded per block; chains may legally reach across block boundaries
(decoder semantics are global, SURVEY.md §2.1.5), which the doubling pass
handles for free because it operates on the whole output vector.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from lz4jpeg_tpu.formats.lz4_frame import Block, unpack_frame


def build_copy_program(blocks: List[Block]) -> Tuple[np.ndarray, np.ndarray]:
    """Blocks → (lit_val u8[N], src i32[N]) with src == -1 at literals."""
    total = sum(
        len(s.literals) + (s.match_length if s.match_offset else 0)
        for b in blocks
        for s in b.sequences
    )
    lit_val = np.zeros(total, np.uint8)
    src = np.full(total, -1, np.int64)
    pos = 0
    for block in blocks:
        for seq in block.sequences:
            n_lit = len(seq.literals)
            lit_val[pos : pos + n_lit] = np.frombuffer(seq.literals, np.uint8)
            pos += n_lit
            if seq.match_offset:
                ml = seq.match_length
                idx = np.arange(pos, pos + ml)
                src[pos : pos + ml] = idx - seq.match_offset
                if seq.match_offset > pos:
                    raise ValueError("match offset reaches before stream start")
                pos += ml
    return lit_val, src


@functools.partial(jax.jit, static_argnames=("steps",))
def resolve_copies(
    lit_val: jnp.ndarray, src: jnp.ndarray, steps: int
) -> jnp.ndarray:
    """Pointer-double ``src`` to its literal roots, then gather bytes."""
    idx = jnp.arange(src.shape[0], dtype=src.dtype)
    # Literals root at themselves — the doubling fixpoint.
    root = jnp.where(src < 0, idx, src)
    root = jax.lax.fori_loop(0, steps, lambda _, r: r[r], root)
    return lit_val[root]


def decode_frame_device(compressed: bytes) -> bytes:
    """Full parity-frame decode with the device copy-resolution path."""
    blocks = unpack_frame(compressed)
    lit_val, src = build_copy_program(blocks)
    n = len(lit_val)
    if n == 0:
        return b""
    steps = max(1, int(np.ceil(np.log2(n))) + 1)
    out = resolve_copies(
        jnp.asarray(lit_val), jnp.asarray(src, jnp.int32), steps
    )
    return bytes(np.asarray(jax.device_get(out)))
