"""ctypes binding for the native track-photometries CSV parser.

Drop-in accelerator for inference/photometries.py:
read_track_photometries_csv (the port of MCsimlib.py:2534-2575): tokenizing
and float-parsing 10^4-10^5 rows dominates ingestion; the C++ pass returns
flat arrays and the dict assembly stays in Python. Falls back to the pure-
Python reader when the toolchain is unavailable or the file is ragged.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ._build import NativeLib

_HERE = os.path.dirname(os.path.abspath(__file__))


def _prototypes(lib):
    lib.tcsv_parse.restype = ctypes.c_void_p
    lib.tcsv_parse.argtypes = [ctypes.c_char_p, ctypes.c_int32,
                               ctypes.c_int32, ctypes.c_int32,
                               ctypes.c_int32]
    lib.tcsv_n_rows.restype = ctypes.c_int64
    lib.tcsv_n_rows.argtypes = [ctypes.c_void_p]
    lib.tcsv_n_frames.restype = ctypes.c_int32
    lib.tcsv_n_frames.argtypes = [ctypes.c_void_p]
    lib.tcsv_channels.restype = ctypes.c_char_p
    lib.tcsv_channels.argtypes = [ctypes.c_void_p]
    for name, ct in (("tcsv_fields", ctypes.c_int32),
                     ("tcsv_hs", ctypes.c_int32),
                     ("tcsv_ws", ctypes.c_int32),
                     ("tcsv_rows", ctypes.c_int64),
                     ("tcsv_cats", ctypes.c_uint8),
                     ("tcsv_frames", ctypes.c_int64)):
        fn = getattr(lib, name)
        fn.restype = ctypes.POINTER(ct)
        fn.argtypes = [ctypes.c_void_p]
    lib.tcsv_free.restype = None
    lib.tcsv_free.argtypes = [ctypes.c_void_p]


_NATIVE = NativeLib(os.path.join(_HERE, "trackcsv.cpp"),
                    os.path.join(_HERE, "_trackcsv.so"), _prototypes)


def _load():
    return _NATIVE.load()


def have_native() -> bool:
    return _load() is not None


def parse_track_csv_native(path, downstep_filtered=False, head_truncate=0,
                           tail_truncate=0, omit_header=True, channels=None):
    """Native-parse a track CSV into the reference (d, d2) dict pair.

    Returns None if the native parser is unavailable or refuses the file
    (ragged frame counts) — the caller should fall back to the Python path.
    """
    lib = _load()
    if lib is None:
        return None
    handle = lib.tcsv_parse(os.fsencode(path), int(head_truncate),
                            int(tail_truncate), int(bool(downstep_filtered)),
                            int(bool(omit_header)))
    if not handle:
        return None
    try:
        n = int(lib.tcsv_n_rows(handle))
        nf = int(lib.tcsv_n_frames(handle))
        if n == 0:
            return {}, {}
        chan_names = lib.tcsv_channels(handle).decode("utf-8").split("\n")
        fields = np.ctypeslib.as_array(lib.tcsv_fields(handle), (n,)).copy()
        hs = np.ctypeslib.as_array(lib.tcsv_hs(handle), (n,)).copy()
        ws = np.ctypeslib.as_array(lib.tcsv_ws(handle), (n,)).copy()
        rows = np.ctypeslib.as_array(lib.tcsv_rows(handle), (n,)).copy()
        if nf == 0:
            # head_truncate ate every frame column: the data pointers of
            # the empty vectors are NULL (as_array would raise); the rows
            # themselves are valid with empty tuples, like the Python
            # reader's.
            cats = np.zeros((n, 0), bool)
            frames = np.zeros((n, 0), np.int64)
        else:
            cats = np.ctypeslib.as_array(lib.tcsv_cats(handle),
                                         (n, nf)).copy().astype(bool)
            frames = np.ctypeslib.as_array(lib.tcsv_frames(handle),
                                           (n, nf)).copy()
    finally:
        lib.tcsv_free(handle)

    # Bulk-convert once (C speed) instead of per-row numpy scalar iteration.
    fields_l = fields.tolist()
    hs_l = hs.tolist()
    ws_l = ws.tolist()
    rows_l = rows.tolist()
    cats_l = cats.tolist()
    frames_l = frames.tolist()
    d = {}
    d2 = {}
    for i in range(n):
        channel = chan_names[i]
        if channels is not None and channel not in channels:
            continue
        parsed_cat = tuple(cats_l[i])
        parsed_frames = tuple(frames_l[i])
        r = rows_l[i]
        d.setdefault(channel, {}).setdefault(fields_l[i], {}).setdefault(
            (hs_l[i], ws_l[i]), (parsed_cat, parsed_frames, r))
        d2.setdefault(r, (channel, fields_l[i], hs_l[i], ws_l[i],
                          parsed_cat, parsed_frames))
    return d, d2


def read_track_photometries_arrays(path, downstep_filtered=False,
                                   head_truncate=0, tail_truncate=0,
                                   omit_header=True):
    """Arrays-native ingestion: parse a track CSV straight to flat numpy
    arrays, skipping the photometries-dict entirely.

    This is the device-first data path: the batched fitters (ops/lognormal.py
    score_traces, ops/stepfit_batch.py) consume (N, F) arrays directly, so
    for large experiments the per-row Python dict/tuple assembly of
    read_track_photometries_csv (MCsimlib.py:2534-2575) is pure overhead.

    Returns a dict with:
        channels: list[str] per row,
        fields, hs, ws: (N,) int32,
        rows: (N,) int64 original CSV record indices,
        categories: (N, F) bool,
        intensities: (N, F) int64.
    None if the native parser is unavailable (callers may fall back to the
    dict reader + manual flattening).
    """
    lib = _load()
    if lib is None:
        return None
    handle = lib.tcsv_parse(os.fsencode(path), int(head_truncate),
                            int(tail_truncate), int(bool(downstep_filtered)),
                            int(bool(omit_header)))
    if not handle:
        return None
    try:
        n = int(lib.tcsv_n_rows(handle))
        nf = int(lib.tcsv_n_frames(handle))
        if n == 0:
            return {"channels": [], "fields": np.zeros(0, np.int32),
                    "hs": np.zeros(0, np.int32), "ws": np.zeros(0, np.int32),
                    "rows": np.zeros(0, np.int64),
                    "categories": np.zeros((0, 0), bool),
                    "intensities": np.zeros((0, 0), np.int64)}
        if nf == 0:
            # NULL data pointers on the empty vectors (see the dict
            # reader above) — build the empty matrices directly.
            cats = np.zeros((n, 0), bool)
            frames = np.zeros((n, 0), np.int64)
        else:
            cats = np.ctypeslib.as_array(
                lib.tcsv_cats(handle), (n, nf)).copy().astype(bool)
            frames = np.ctypeslib.as_array(lib.tcsv_frames(handle),
                                           (n, nf)).copy()
        return {
            "channels": lib.tcsv_channels(handle).decode("utf-8").split("\n"),
            "fields": np.ctypeslib.as_array(lib.tcsv_fields(handle),
                                            (n,)).copy(),
            "hs": np.ctypeslib.as_array(lib.tcsv_hs(handle), (n,)).copy(),
            "ws": np.ctypeslib.as_array(lib.tcsv_ws(handle), (n,)).copy(),
            "rows": np.ctypeslib.as_array(lib.tcsv_rows(handle), (n,)).copy(),
            "categories": cats,
            "intensities": frames,
        }
    finally:
        lib.tcsv_free(handle)
