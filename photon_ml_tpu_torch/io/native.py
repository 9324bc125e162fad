"""Native (C++) Avro -> columnar ingest and scored-output writer
(counterpart of ``photon_ml_tpu/io/native.py``; the C++ source is the
port's own copy, ``photon_ml_tpu_torch/native/avro_reader.cpp``).

The pure-Python codec (:mod:`photon_ml_tpu_torch.io.avro`) interprets the
schema per value; this module compiles the schema once into a flat opcode
program and hands whole container blocks to the C++ reader, which decodes
records, performs the vocabulary join ((name, term) -> column id) and
accumulates columnar outputs natively. Python only sees numpy arrays.

The shared library builds with ``g++`` at first use into
``photon_ml_tpu_torch/native/_build/`` (listed in ``.gitignore``), named by
a hash of the source and the flags, written to a temporary name and moved
into place, so that processes building at once never load a half-written
library. If the toolchain or zlib is missing every entry point reports
unavailable and callers take the Python codec. Not ported here:
``scan_feature_keys`` (the vocabulary scan, with the ingest hooks).
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import json
import os
import subprocess
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.io.avro import MAGIC, _decode_bytes, _decode_long

# ---------------------------------------------------------------------------
# opcode constants (must mirror photon_ml_tpu_torch/native/avro_reader.cpp)
# ---------------------------------------------------------------------------

OP_SCALAR_COL = 1
OP_UID = 2
OP_FEATURES = 3
OP_METADATA = 4
OP_SKIP = 5
OPTIONAL_BIT = 1 << 8
NULL_SECOND_BIT = 1 << 9

W_NULL = 0
W_BOOLEAN = 1
W_INT = 2
W_LONG = 3
W_FLOAT = 4
W_DOUBLE = 5
W_STRING = 6
W_BYTES = 7
W_FEATURE_ARRAY = 8
W_STRING_MAP = 9

_PRIM_WIRE = {
    "null": W_NULL,
    "boolean": W_BOOLEAN,
    "int": W_INT,
    "long": W_LONG,
    "float": W_FLOAT,
    "double": W_DOUBLE,
    "string": W_STRING,
    "bytes": W_BYTES,
}

# scalar column slots (fixed layout, see ingest wrappers below)
COL_LABEL, COL_OFFSET, COL_WEIGHT = 0, 1, 2

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native",
                    "avro_reader.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_SRC), "_build")
_BASE_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
# libdeflate inflates ~2-3x faster than zlib; zlib alone where its
# development files are missing
_LINK_CHOICES = (("-DPML_USE_LIBDEFLATE", "-ldeflate", "-lz"), ("-lz",))

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_error: Optional[str] = None

# Live native-handle census: every successfully created reader/vocabset
# handle increments, every close() decrements; the tests assert it returns
# to zero after every ingest entry point.
_handle_lock = threading.Lock()
_live_handles = 0


def _note_handle(delta: int) -> None:
    global _live_handles
    with _handle_lock:
        _live_handles += delta


def live_native_handles() -> int:
    """Number of currently open native reader/vocabset handles."""
    with _handle_lock:
        return _live_handles


def library_path() -> str:
    """``_build/libpml_avro-<hash>.so``, the hash over the source and the
    compiler flags: an edited source builds anew."""
    digest = hashlib.sha256()
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(_BASE_FLAGS + sum(_LINK_CHOICES, ())).encode())
    return os.path.join(BUILD_DIR, f"libpml_avro-{digest.hexdigest()[:16]}.so")


def _build(so: str) -> Optional[str]:
    """Compile the library into ``so`` (through a temporary file); the
    compiler's error, or None."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    err = ""
    for link in _LINK_CHOICES:
        proc = subprocess.run(
            ["g++", *_BASE_FLAGS, _SRC, "-o", tmp, *link],
            capture_output=True, text=True, timeout=300,
        )
        if proc.returncode == 0:
            os.replace(tmp, so)
            return None
        err = proc.stderr[-2000:]
    if os.path.exists(tmp):
        os.remove(tmp)
    return f"native build failed: {err}"


def _load(so: str) -> ctypes.CDLL:
    """The library at ``so``; one built where it does not load (a build
    of another machine, linked against a library this one lacks) is built
    anew."""
    try:
        return ctypes.CDLL(so)
    except OSError:
        error = _build(so)
        if error is not None:
            raise OSError(error) from None
        return ctypes.CDLL(so)


def _build_and_load() -> Tuple[Optional[ctypes.CDLL], Optional[str]]:
    try:
        so = library_path()
        if not os.path.exists(so):
            error = _build(so)
            if error is not None:
                return None, error
        lib = _load(so)
        lib.pml_vocabset_new.restype = ctypes.c_void_p
        lib.pml_vocabset_new.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        lib.pml_vocabset_free.argtypes = [ctypes.c_void_p]
        lib.pml_reader_new.restype = ctypes.c_void_p
        lib.pml_reader_new.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_void_p,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32, ctypes.c_int32,
        ]
        lib.pml_reader_feed_blocks_mt.restype = ctypes.c_int64
        lib.pml_reader_feed_blocks_mt.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_char_p,
            ctypes.c_int32,
        ]
        lib.pml_reader_nrecords.restype = ctypes.c_int64
        lib.pml_reader_nrecords.argtypes = [ctypes.c_void_p]
        lib.pml_reader_sizes.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)
        ]
        lib.pml_reader_scalar.argtypes = [
            ctypes.c_void_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.pml_reader_strings.argtypes = [
            ctypes.c_void_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p,
        ]
        lib.pml_reader_coo.argtypes = [
            ctypes.c_void_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.pml_reader_error.restype = ctypes.c_char_p
        lib.pml_reader_error.argtypes = [ctypes.c_void_p]
        lib.pml_reader_free.argtypes = [ctypes.c_void_p]
        lib.pml_write_columnar.restype = ctypes.c_int64
        lib.pml_write_columnar.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_int64,
        ]
        return lib, None
    except Exception as e:  # noqa: BLE001 — any failure means "unavailable"
        return None, f"{type(e).__name__}: {e}"


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_error
    with _lib_lock:
        if _lib is None and _lib_error is None:
            _lib, _lib_error = _build_and_load()
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def native_error() -> Optional[str]:
    get_lib()
    return _lib_error


# ---------------------------------------------------------------------------
# schema -> opcode program
# ---------------------------------------------------------------------------


class UnsupportedSchema(ValueError):
    """Raised when the native path cannot handle a schema; callers fall
    back to the Python codec."""


def _unwrap_optional(ftype):
    """[null, X] / [X, null] -> (X, optional?, null_second?)."""
    if isinstance(ftype, list):
        if len(ftype) == 2 and "null" in ftype:
            null_second = ftype[1] == "null"
            inner = ftype[0] if null_second else ftype[1]
            return inner, True, null_second
        raise UnsupportedSchema(f"unsupported union {ftype!r}")
    return ftype, False, False


def _wire_of(ftype) -> int:
    if isinstance(ftype, str):
        if ftype in _PRIM_WIRE:
            return _PRIM_WIRE[ftype]
        raise UnsupportedSchema(f"named-type reference {ftype!r}")
    if isinstance(ftype, dict):
        t = ftype.get("type")
        if t in _PRIM_WIRE:
            return _PRIM_WIRE[t]
        if t == "map" and ftype.get("values") == "string":
            return W_STRING_MAP
    raise UnsupportedSchema(f"unsupported field type {ftype!r}")


_SCALAR_WIRES = (W_BOOLEAN, W_INT, W_LONG, W_FLOAT, W_DOUBLE)


def compile_schema(
    schema: dict,
    *,
    label_field: str = "label",
    want_entities: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Compile a TrainingExample-family record schema into the native
    field program. Returns (field_prog (nfields, 3) int32, feat_desc int32).

    ``label_field`` follows the active field-name set ("label" for
    TRAINING_EXAMPLE, "response" for RESPONSE_PREDICTION,
    ``avro/FieldNamesType.scala:20``).
    """
    if schema.get("type") != "record":
        raise UnsupportedSchema("top-level schema must be a record")
    prog: List[Tuple[int, int, int]] = []
    feat_desc: Optional[List[int]] = None
    for f in schema["fields"]:
        name = f["name"]
        ftype, optional, null_second = _unwrap_optional(f["type"])
        bits = (OPTIONAL_BIT if optional else 0) | (
            NULL_SECOND_BIT if null_second else 0
        )
        if name == label_field:
            wire = _wire_of(ftype)
            if wire not in _SCALAR_WIRES:
                raise UnsupportedSchema(f"label field has wire {wire}")
            prog.append((OP_SCALAR_COL | bits, wire, COL_LABEL))
        elif name == "offset":
            prog.append((OP_SCALAR_COL | bits, _wire_of(ftype), COL_OFFSET))
        elif name == "weight":
            prog.append((OP_SCALAR_COL | bits, _wire_of(ftype), COL_WEIGHT))
        elif name == "uid":
            wire = _wire_of(ftype)
            if wire != W_STRING:
                raise UnsupportedSchema("uid must be a string")
            prog.append((OP_UID | bits, wire, 0))
        elif name == "features":
            if not (isinstance(ftype, dict) and ftype.get("type") == "array"):
                raise UnsupportedSchema("features must be an array")
            items = ftype["items"]
            if not (isinstance(items, dict) and items.get("type") == "record"):
                raise UnsupportedSchema("features items must be records")
            fname = fterm = fvalue = -1
            wires: List[Tuple[int, int]] = []
            for i, ff in enumerate(items["fields"]):
                it, iopt, insec = _unwrap_optional(ff["type"])
                if insec:
                    raise UnsupportedSchema(
                        "feature-record [X, null] unions unsupported"
                    )
                w = _wire_of(it)
                wires.append((w, 1 if iopt else 0))
                if ff["name"] == "name":
                    fname = i
                elif ff["name"] == "term":
                    fterm = i
                elif ff["name"] == "value":
                    fvalue = i
            if fname < 0 or fvalue < 0:
                raise UnsupportedSchema("feature record needs name+value")
            feat_desc = [len(wires), fname, fterm, fvalue]
            for w, o in wires:
                feat_desc += [w, o]
            prog.append((OP_FEATURES | bits, W_FEATURE_ARRAY, 0))
        elif name == "metadataMap" and want_entities:
            wire = _wire_of(ftype)
            if wire != W_STRING_MAP:
                raise UnsupportedSchema("metadataMap must be map<string>")
            prog.append((OP_METADATA | bits, wire, 0))
        else:
            prog.append((OP_SKIP | bits, _wire_of(ftype), 0))
    if feat_desc is None:
        raise UnsupportedSchema("schema has no features array")
    return (
        np.asarray(prog, np.int32),
        np.asarray(feat_desc, np.int32),
    )


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _f64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class NativeVocabSet:
    """Immutable native vocabulary hash maps, built ONCE per ingest and
    shared read-only by every per-file reader (and thread).

    vocab_keys: per vocabulary, the ordered feature keys (name\\x01term),
    transported as one byte blob + explicit offsets — never joined by a
    separator byte, so feature names may contain any character."""

    def __init__(
        self,
        vocab_keys: Sequence[Sequence[str]],
        vocab_intercepts: Sequence[int],
    ):
        lib = get_lib()
        if lib is None:
            raise RuntimeError(f"native reader unavailable: {_lib_error}")
        self._lib = lib
        self.nvocabs = len(vocab_keys)
        key_bytes = [
            k.encode("utf-8") for keys in vocab_keys for k in keys
        ]
        vocab_blob = b"".join(key_bytes)
        key_offsets = np.zeros(len(key_bytes) + 1, np.int64)
        np.cumsum([len(b) for b in key_bytes], out=key_offsets[1:])
        vocab_counts = np.asarray(
            [len(k) for k in vocab_keys], np.int32
        )
        intercepts = np.asarray(
            [(-1 if i is None else i) for i in vocab_intercepts], np.int32
        )
        self._handle = lib.pml_vocabset_new(
            vocab_blob,
            _i64p(key_offsets),
            _i32p(vocab_counts) if self.nvocabs else _i32p(np.zeros(1, np.int32)),
            _i32p(intercepts) if self.nvocabs else _i32p(np.zeros(1, np.int32)),
            self.nvocabs,
        )
        if not self._handle:
            raise RuntimeError("pml_vocabset_new failed")
        _note_handle(+1)

    @property
    def handle(self):
        return self._handle

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.pml_vocabset_free(self._handle)
            self._handle = None
            _note_handle(-1)

    # context-manager form: deterministic release at every ingest call
    # site (threaded decode must not lean on best-effort __del__ —
    # a handle per retry attempt leaks O(chunks) otherwise)
    def __enter__(self) -> "NativeVocabSet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # pragma: no cover — best effort
        try:
            self.close()
        except Exception:
            pass


class NativeAvroReader:
    """Streams Avro container files into native columnar accumulators.

    vocabset: a NativeVocabSet (may be shared across readers; must stay
    alive for this reader's lifetime).
    entity_keys: metadataMap keys to extract as per-row string columns.
    """

    def __init__(
        self,
        field_prog: np.ndarray,
        feat_desc: np.ndarray,
        vocabset: NativeVocabSet,
        entity_keys: Sequence[str] = (),
    ):
        lib = get_lib()
        if lib is None:
            raise RuntimeError(f"native reader unavailable: {_lib_error}")
        self._lib = lib
        self._nvocabs = vocabset.nvocabs
        self._nentities = len(entity_keys)
        ent_bytes = [k.encode("utf-8") for k in entity_keys]
        entity_blob = b"".join(ent_bytes)
        entity_offsets = np.zeros(len(ent_bytes) + 1, np.int64)
        np.cumsum([len(b) for b in ent_bytes], out=entity_offsets[1:])
        self._handle = lib.pml_reader_new(
            _i32p(np.ascontiguousarray(field_prog)),
            len(field_prog),
            _i32p(np.ascontiguousarray(feat_desc)),
            vocabset.handle,
            entity_blob,
            _i64p(entity_offsets),
            self._nentities,
            0,  # no distinct-key collection: the vocabulary scan is not ported
        )
        if not self._handle:
            raise RuntimeError("pml_reader_new failed")
        _note_handle(+1)
        # the vocab set must outlive the reader (C side is non-owning)
        self._keepalive = (vocabset, entity_blob, entity_offsets)

    def feed_file(
        self,
        path: str,
        expected_schema: Optional[dict] = None,
        decode_threads: int = 1,
    ):
        """Decode a whole container file natively. The file is mmap'd (no
        whole-body heap copy — peak host RAM stays flat however many files
        decode concurrently) and handed to C with a start offset; block
        framing, sync verification, inflate, record decode and the vocab
        join all run with the GIL released. ``decode_threads > 1`` decodes
        blocks on a native thread pool with an order-preserving merge —
        output is identical to a sequential read. When
        ``expected_schema`` is given, a file written with a different
        schema raises :class:`UnsupportedSchema` (the caller falls back to
        the schema-general Python codec) instead of misdecoding."""
        import mmap

        with open(path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            if size == 0:
                raise ValueError(f"{path} is not an Avro container file")
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        try:
            # header slices start at 4MB and double on truncation (huge
            # schema / metadata blocks are rare but legal)
            cap = 4 * 1024 * 1024
            while True:
                head = mm[: min(size, cap)]
                buf = io.BytesIO(head)
                if buf.read(4) != MAGIC:
                    raise ValueError(f"{path} is not an Avro container file")
                try:
                    meta = {}
                    while True:
                        count = _decode_long(buf)
                        if count == 0:
                            break
                        if count < 0:
                            _decode_long(buf)
                            count = -count
                        for _ in range(count):
                            k = _decode_bytes(buf).decode("utf-8")
                            meta[k] = _decode_bytes(buf)
                    # a silently-short _decode_bytes read lands exactly at
                    # EOF; requiring room for the sync marker catches it
                    if buf.tell() + 16 > len(head) and cap < size:
                        raise EOFError("truncated header slice")
                    break
                except (ValueError, EOFError, IndexError):
                    if cap >= size:
                        raise
                    cap *= 2
            if expected_schema is not None:
                schema = json.loads(meta["avro.schema"])
                if schema != expected_schema:
                    raise UnsupportedSchema(
                        f"{path} was written with a different schema than "
                        "the compiled program"
                    )
            codec_name = meta.get("avro.codec", b"null").decode()
            codec = {"null": 0, "deflate": 1}.get(codec_name)
            if codec is None:
                raise ValueError(f"unsupported codec {codec_name!r}")
            sync = buf.read(16)
            # zero-copy: the C side reads straight from the mapping
            arr = np.frombuffer(mm, np.uint8)
            got = self._lib.pml_reader_feed_blocks_mt(
                self._handle,
                ctypes.c_void_p(arr.ctypes.data),
                buf.tell(),
                size,
                codec,
                sync,
                max(1, int(decode_threads)),
            )
            if got < 0:
                err = self._lib.pml_reader_error(self._handle).decode()
                raise ValueError(f"{path}: native decode failed: {err}")
            return json.loads(meta["avro.schema"])
        finally:
            # drop the exported buffer before closing the map (mmap.close
            # raises BufferError while a frombuffer view is alive)
            arr = None  # noqa: F841
            mm.close()

    # -- extraction ---------------------------------------------------------

    @property
    def num_records(self) -> int:
        return int(self._lib.pml_reader_nrecords(self._handle))

    def _sizes(self) -> np.ndarray:
        out = np.zeros(1 + self._nentities + self._nvocabs, np.int64)
        self._lib.pml_reader_sizes(self._handle, _i64p(out))
        return out

    def scalar(self, col: int) -> Tuple[np.ndarray, np.ndarray]:
        n = self.num_records
        vals = np.zeros(n, np.float64)
        seen = np.zeros(n, np.uint8)
        self._lib.pml_reader_scalar(self._handle, col, _f64p(vals), _u8p(seen))
        return vals, seen.astype(bool)

    def _strings(self, which: int, nbytes: int) -> np.ndarray:
        n = self.num_records
        offsets = np.zeros(n + 1, np.int64)
        raw = ctypes.create_string_buffer(max(nbytes, 1))
        self._lib.pml_reader_strings(self._handle, which, _i64p(offsets), raw)
        blob = raw.raw[:nbytes]
        # bulk decode: ONE utf-8 decode of the whole pool, then slice the
        # str by character positions (byte offsets -> char offsets via a
        # continuation-byte prefix sum) — no per-string decode() calls on
        # the hot ingest path
        text = blob.decode("utf-8")
        if len(text) == nbytes:  # pure ASCII: byte offsets == char offsets
            char_off = offsets
        else:
            starts = (np.frombuffer(blob, np.uint8) & 0xC0) != 0x80
            cum = np.zeros(nbytes + 1, np.int64)
            np.cumsum(starts, out=cum[1:])
            char_off = cum[offsets]
        out = np.empty(n, object)
        out[:] = [
            text[char_off[i]:char_off[i + 1]] for i in range(n)
        ]
        return out

    def uids(self) -> np.ndarray:
        nbytes = int(self._sizes()[0])
        out = self._strings(-1, nbytes)
        # the pool cannot distinguish null from "": treat empty as absent,
        # matching the optional-uid semantics of ingest
        out[out == ""] = None
        return out

    def entities(self, which: int) -> np.ndarray:
        nbytes = int(self._sizes()[1 + which])
        return self._strings(which, nbytes)

    def coo(self, vocab: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        nnz = int(self._sizes()[1 + self._nentities + vocab])
        rows = np.zeros(nnz, np.int32)
        cols = np.zeros(nnz, np.int32)
        vals = np.zeros(nnz, np.float64)
        if nnz:
            self._lib.pml_reader_coo(
                self._handle, vocab, _i32p(rows), _i32p(cols), _f64p(vals)
            )
        return rows, cols, vals

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.pml_reader_free(self._handle)
            self._handle = None
            _note_handle(-1)

    def __enter__(self) -> "NativeAvroReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # pragma: no cover — best effort
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# high-level ingest entry points
# ---------------------------------------------------------------------------


def _map_files(paths: Sequence[str], fn, max_workers: Optional[int]):
    """Shared parallel scaffold for per-file native passes: single-file
    shortcut, bounded thread pool (ctypes releases the GIL during the C
    decode), results in path order."""
    if len(paths) == 1:
        return [fn(paths[0])]
    from concurrent.futures import ThreadPoolExecutor

    workers = max_workers or min(len(paths), os.cpu_count() or 4, 16)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(fn, paths))


def _default_decode_threads(
    num_files: int, max_workers: Optional[int] = None
) -> int:
    """Block-decode threads per file: split the cores across CONCURRENTLY
    decoding files (files parallelize via ``_map_files``, capped by
    ``max_workers``); a single file gets the whole machine. (The JAX
    package's ``PHOTON_DECODE_THREADS`` override is not ported.)"""
    cores = os.cpu_count() or 1
    concurrent = min(num_files, cores, 16)
    if max_workers:
        concurrent = min(concurrent, max_workers)
    return max(1, cores // max(1, concurrent))


def _read_header_schema(path: str) -> dict:
    with open(path, "rb") as f:
        head = f.read(4 * 1024 * 1024)
    buf = io.BytesIO(head)
    if buf.read(4) != MAGIC:
        raise ValueError(f"{path} is not an Avro container file")
    meta = {}
    while True:
        count = _decode_long(buf)
        if count == 0:
            break
        if count < 0:
            _decode_long(buf)
            count = -count
        for _ in range(count):
            k = _decode_bytes(buf).decode("utf-8")
            meta[k] = _decode_bytes(buf)
    return json.loads(meta["avro.schema"])


# write ops (must mirror photon_ml_tpu_torch/native/avro_reader.cpp)
WOP_DOUBLE = 1
WOP_OPT_DOUBLE = 2
WOP_OPT_STRING = 3
WOP_NULL_UNION = 4
WOP_FLOAT = 5
WOP_OPT_FLOAT = 6


def write_columnar_avro(
    path: str,
    schema: dict,
    columns: Dict[str, object],
    n: int,
    codec: str = "deflate",
) -> None:
    """Write an Avro container file of FLAT records straight from columnar
    arrays — the native fast path for the scoring driver's output
    (``cli/game/scoring/Driver.scala`` ScoredItems write). Per field the
    column value is:

    - ``double``           -> (n,) float array
    - ``[null, double]``   -> ((n,) floats, (n,) present bools)
    - ``[null, string]``   -> (n,) object array of str/None ("" == null)
    - ``[null, <any>]`` always-null -> None

    Schemas outside this family raise :class:`UnsupportedSchema`; callers
    fall back to the Python codec."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native writer unavailable: {_lib_error}")
    if schema.get("type") != "record":
        raise UnsupportedSchema("top-level schema must be a record")
    ops: List[Tuple[int, int]] = []
    dcols: List[np.ndarray] = []
    pcols: List[np.ndarray] = []
    pools: List[np.ndarray] = []
    def _col(arr, what):
        a = np.asarray(arr)
        if a.shape != (n,):
            raise ValueError(
                f"{what}: expected shape ({n},), got {a.shape}"
            )
        return a

    # schema-family check over ALL fields first, so an unsupported schema
    # reports UnsupportedSchema (-> Python-codec fallback) rather than a
    # missing-column error for some earlier field
    for f in schema["fields"]:
        ftype = f["type"]
        if not (
            ftype in ("double", "float")
            or (
                isinstance(ftype, list)
                and len(ftype) == 2
                and ftype[0] == "null"
            )
        ):
            raise UnsupportedSchema(f"field {f['name']!r} type {ftype!r}")
    for f in schema["fields"]:
        name = f["name"]
        ftype = f["type"]
        if name not in columns:
            # absent-by-typo must not silently become all-null output
            raise KeyError(
                f"no column provided for schema field {name!r} "
                "(pass None explicitly for always-null fields)"
            )
        value = columns[name]
        if ftype == "double" or ftype == "float":
            # float fields get the 4-byte wire op — encoding them as
            # 8-byte doubles would silently corrupt the file
            ops.append(
                (WOP_DOUBLE if ftype == "double" else WOP_FLOAT, len(dcols))
            )
            dcols.append(_col(value, name).astype(np.float64))
        elif isinstance(ftype, list) and len(ftype) == 2 and ftype[0] == "null":
            inner = ftype[1]
            if value is None:
                ops.append((WOP_NULL_UNION, 0))
            elif inner == "double" or inner == "float":
                vals, present = value
                ops.append(
                    (
                        WOP_OPT_DOUBLE if inner == "double" else WOP_OPT_FLOAT,
                        len(dcols),
                    )
                )
                dcols.append(_col(vals, name).astype(np.float64))
                pcols.append(
                    _col(present, f"{name} present flags").astype(np.uint8)
                )
            elif inner == "string":
                ops.append((WOP_OPT_STRING, len(pools)))
                pools.append(_col(np.asarray(value, object), name))
            else:
                ops.append((WOP_NULL_UNION, 0))
                if value is not None and any(v is not None for v in np.atleast_1d(value)):
                    raise UnsupportedSchema(
                        f"field {name!r}: only always-null {inner} unions "
                        "are supported natively"
                    )
    # doubles: stacked (ncols, n); present flags: aligned to the same col
    # index as their doubles column (plain doubles get all-1 rows)
    nd = len(dcols)
    doubles = (
        np.ascontiguousarray(np.stack(dcols)) if nd else np.zeros((1, 1))
    )
    present = np.ones((max(nd, 1), n), np.uint8)
    pi = 0
    for (op, arg) in ops:
        if op in (WOP_OPT_DOUBLE, WOP_OPT_FLOAT):
            present[arg] = pcols[pi]
            pi += 1
    # pools: absolute offsets into one concatenated byte blob
    offset_rows = []
    blobs = []
    base = 0
    for pool in pools:
        enc = [
            b"" if v is None else str(v).encode("utf-8") for v in pool
        ]
        lens = np.asarray([len(e) for e in enc], np.int64)
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        offset_rows.append(offs + base)
        blob = b"".join(enc)
        blobs.append(blob)
        base += len(blob)
    pool_offsets = (
        np.ascontiguousarray(np.concatenate(offset_rows))
        if pools
        else np.zeros(1, np.int64)
    )
    pool_bytes = b"".join(blobs)
    ops_arr = np.asarray(ops, np.int32).reshape(-1)
    rc = lib.pml_write_columnar(
        path.encode("utf-8"),
        json.dumps(schema).encode("utf-8"),
        n,
        _i32p(np.ascontiguousarray(ops_arr)),
        len(ops),
        _f64p(doubles),
        _u8p(np.ascontiguousarray(present)),
        _i64p(pool_offsets),
        pool_bytes,
        os.urandom(16),
        {"null": 0, "deflate": 1}[codec],
        4096,
    )
    if rc != 0:
        raise IOError(f"native Avro write failed (rc={rc}) for {path}")


def _extract_columns(reader: NativeAvroReader, entity_keys, nvocabs):
    n = reader.num_records
    labels, label_seen = reader.scalar(COL_LABEL)
    offsets, _ = reader.scalar(COL_OFFSET)
    weights, w_seen = reader.scalar(COL_WEIGHT)
    return {
        "n": n,
        "labels": labels,
        "label_present": label_seen,
        "offsets": offsets,
        "weights": np.where(w_seen, weights, 1.0),
        "uids": reader.uids(),
        "entities": {
            k: reader.entities(i) for i, k in enumerate(entity_keys)
        },
        "coo": [reader.coo(i) for i in range(nvocabs)],
    }


def read_columnar(
    paths: Sequence[str],
    vocabs: Sequence,
    entity_keys: Sequence[str] = (),
    *,
    label_field: str = "label",
    allow_null_labels: bool = False,
    max_workers: Optional[int] = None,
    decode_threads: Optional[int] = None,
) -> Dict[str, object]:
    """Read Avro files into columnar arrays with native decode + vocab join.

    vocabs: FeatureVocabulary objects (ordered keys + intercept index).
    Returns {labels, offsets, weights, uids, entities: {key: str array},
    coo: [(rows, cols, vals), ...] per vocab, n}.

    Matches the Python path's semantics: weight/offset nulls default to
    1.0/0.0, null labels only allowed when ``allow_null_labels`` (scoring),
    features missing from a vocabulary are dropped, intercept column left
    for the caller to inject (as ingest does).

    Parallelism on one host has two levels, both defaulting to the core
    count (the executor-side parallelism of the reference's Spark ingest):
    multi-file inputs decode concurrently (one native reader per file;
    ctypes releases the GIL), and within each file container BLOCKS decode
    on a native thread pool (``decode_threads`` per file) with an
    order-preserving merge — output row order is identical to a
    sequential read either way.
    """
    if not paths:
        raise FileNotFoundError("no input files")
    # compile against the first file's writer schema; the vocab hash maps
    # build ONCE and are shared read-only across per-file readers
    schema = _read_header_schema(paths[0])
    field_prog, feat_desc = compile_schema(
        schema, label_field=label_field, want_entities=bool(entity_keys)
    )
    vocabset = NativeVocabSet(
        [v.index_to_key for v in vocabs],
        [v.intercept_index for v in vocabs],
    )

    def check_labels(part, path):
        if not allow_null_labels and not part["label_present"].all():
            i = int(np.argmin(part["label_present"]))
            raise ValueError(
                f"record {i} of {path} has a null/missing label; training "
                "input requires labels (pass allow_null_labels=True only "
                "for scoring)"
            )
        return part

    threads = (
        decode_threads
        if decode_threads is not None
        else _default_decode_threads(len(paths), max_workers)
    )

    def read_one(path: str) -> Dict[str, object]:
        with NativeAvroReader(
            field_prog, feat_desc, vocabset, entity_keys
        ) as reader:
            reader.feed_file(
                path, expected_schema=schema, decode_threads=threads
            )
            # per-part label check: a doomed training input fails before
            # the remaining files/columns are extracted
            return check_labels(
                _extract_columns(reader, entity_keys, len(vocabs)), path
            )

    with vocabset:
        parts = _map_files(paths, read_one, max_workers)
    if len(parts) == 1:
        # common case: hand back the reader's arrays directly, no
        # concatenate copies
        return parts[0]

    # concatenate in path order; COO row ids shift by the running total
    n = sum(p["n"] for p in parts)
    row_base = np.cumsum([0] + [p["n"] for p in parts])[:-1]
    coo = []
    for vi in range(len(vocabs)):
        rows = np.concatenate(
            [
                p["coo"][vi][0].astype(np.int64) + base
                for p, base in zip(parts, row_base)
            ]
        )
        cols = np.concatenate([p["coo"][vi][1] for p in parts])
        vals = np.concatenate([p["coo"][vi][2] for p in parts])
        coo.append((rows, cols, vals))
    return {
        "n": n,
        "labels": np.concatenate([p["labels"] for p in parts]),
        "label_present": np.concatenate(
            [p["label_present"] for p in parts]
        ),
        "offsets": np.concatenate([p["offsets"] for p in parts]),
        "weights": np.concatenate([p["weights"] for p in parts]),
        "uids": np.concatenate([p["uids"] for p in parts]),
        "entities": {
            k: np.concatenate([p["entities"][k] for p in parts])
            for k in entity_keys
        },
        "coo": coo,
    }
