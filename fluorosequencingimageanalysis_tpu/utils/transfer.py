"""Device->host transfer packing: N result arrays -> one blob per byte
width.

Every fetch is a host<->device round trip, so a result dict of nine
arrays costs nine latencies per group even when the copies themselves
were started async. Packing same-itemsize
arrays into ONE concatenated blob per byte width (everything bitcast to
the width's canonical integer type; bool widened to int8) turns that into
<= 3 round trips with bit-exact values — bitcasting moves bytes, never
rounds.

Used by the experiment group pipeline (api._stack_step_groups); the lean
zstack fetch (models/detect.pack_spot_buckets) is the same idea
specialized to keep-first compaction.
"""

from __future__ import annotations

import functools

import numpy as np

_WIDTH = {"float64": 8, "int64": 8, "uint64": 8,
          "float32": 4, "int32": 4, "uint32": 4,
          "int16": 2, "uint16": 2,
          "int8": 1, "uint8": 1, "bool": 1}


@functools.lru_cache(maxsize=32)
def _packer(spec):
    """Jitted blob packer for one (key, shape, dtype) signature. Returns
    fn(dict) -> dict of blobs keyed by itemsize."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    target = {8: jnp.int64, 4: jnp.int32, 2: jnp.int16, 1: jnp.int8}

    def pack(arrs):
        buckets = {}
        for key, shape, dtype in spec:
            a = arrs[key]
            flat = a.reshape((shape[0], -1))
            size = _WIDTH[dtype]
            if dtype == "bool":
                flat = flat.astype(jnp.int8)
            elif flat.dtype != target[size]:
                # Same-width bitcast: bytes move, values never round.
                flat = lax.bitcast_convert_type(flat, target[size])
            buckets.setdefault(size, []).append(flat)
        return {size: jnp.concatenate(lst, axis=1)
                for size, lst in buckets.items()}

    return jax.jit(pack)


def pack_for_transfer(arrs):
    """Pack a dict of [g, ...] device arrays (shared leading axis) into
    per-itemsize transfer blobs. Returns (blobs, spec); feed both to
    :func:`unpack_transfer` after fetching. Supported dtypes: float32,
    int32, uint32, int16, uint16, int8, uint8, bool."""
    spec = tuple((k, tuple(arrs[k].shape), str(arrs[k].dtype))
                 for k in sorted(arrs))
    for _, shape, dtype in spec:
        if dtype not in _WIDTH:
            raise ValueError(f"unsupported transfer dtype {dtype}")
        if shape[0] != spec[0][1][0]:
            raise ValueError("all arrays must share the leading axis")
    blobs = _packer(spec)(dict(arrs))
    return blobs, spec


def unpack_transfer(blobs, spec):
    """Host-side inverse of :func:`pack_for_transfer`: fetches the blobs
    (np.asarray) and rebuilds the original dict, bit-exactly."""
    host = {size: np.asarray(b) for size, b in blobs.items()}
    offsets = dict.fromkeys(host, 0)
    out = {}
    for key, shape, dtype in spec:
        width = (int(np.prod(shape[1:], dtype=np.int64))
                 if len(shape) > 1 else 1)
        size = _WIDTH[dtype]
        lo = offsets[size]
        cols = np.ascontiguousarray(host[size][:, lo:lo + width])
        offsets[size] = lo + width
        if dtype == "bool":
            cols = cols.astype(bool)
        else:
            cols = cols.view(np.dtype(dtype))
        out[key] = cols.reshape(shape)
    return out


def transfer_nbytes(blobs):
    """Total bytes the packed fetch moves (for the profiling ledger)."""
    return int(sum(int(np.prod(b.shape, dtype=np.int64)) * b.dtype.itemsize
                   for b in blobs.values()))
