"""The JAX package's checkpoint file, read and written without flax
(rdfc_gan_tpu/utils/checkpoint.py:27-91): every JAX driver writes and
reads it (``epoch_{n}.ckpt``, ``best.ckpt``).

    8 bytes   magic ``RDFCTPU2`` (``RDFCTPU1`` in files of the first round)
    8 bytes   the header's length, little-endian
    header    JSON ``meta`` ({epoch, ...}); pickled in an RDFCTPU1 file
    payload   flax msgpack (``utils.msgpack_codec``) of the GANTrainState:
              {step, params: {net: tree}, batch_stats: {net: tree},
               opt_states: {optimizer: optax state}}

An RDFCTPU1 header is never unpickled (unpickling a downloaded file could
run arbitrary code): its meta reads as {} with a warning, as in JAX.
``utils.checkpoint`` tells the file from a ``torch.save`` one by its
first bytes, never by its suffix.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Optional, Tuple

from . import msgpack_codec

MAGIC = b"RDFCTPU2"
MAGIC_V1 = b"RDFCTPU1"


def sorted_tree(tree):
    """``tree`` with every dict's keys sorted: the order in which flax
    writes a JAX pytree's maps (a tree map rebuilds each dict sorted)."""
    if isinstance(tree, dict):
        return {k: sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def read_state(filename: str) -> Tuple[Dict[str, Any], Dict]:
    """(the state tree, meta) of a JAX checkpoint. The payload is read once
    into one buffer, and the tree's arrays are views into it. Raises
    ValueError naming a file with neither magic."""
    with open(filename, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic not in (MAGIC, MAGIC_V1):
            raise ValueError(f"{filename} is not a JAX checkpoint: it starts "
                             f"with {magic!r}, not {MAGIC!r} or "
                             f"{MAGIC_V1!r}")
        header = f.read(int.from_bytes(f.read(8), "little"))
        if magic == MAGIC_V1:
            logging.getLogger(__name__).warning(
                "%s is a legacy (V1-header) checkpoint: its pickled meta "
                "header is not read, so epoch and batch metadata are "
                "unavailable", filename)
            meta = {}
        else:
            meta = json.loads(header.decode("utf-8"))
        buf = bytearray(os.fstat(f.fileno()).st_size - f.tell())
        view = memoryview(buf)
        got = 0
        while got < len(buf):
            n = f.readinto(view[got:])
            if not n:
                raise ValueError(f"{filename} ends inside its payload")
            got += n
    return msgpack_codec.unpackb(view), meta


def write_state(filename: str, tree: Dict[str, Any],
                meta: Optional[Dict] = None):
    """Write ``tree`` (maps in the order given; numpy arrays or CPU tensors)
    under the RDFCTPU2 header, leaf by leaf, atomically."""
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    header = json.dumps(meta or {}, default=str).encode("utf-8")
    tmp = f"{filename}.tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        msgpack_codec.pack(tree, f.write)
    os.replace(tmp, filename)
