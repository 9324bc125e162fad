"""Self-contained Avro object-container codec (read + write).

The reference consumes/produces Avro everywhere (``avro/AvroIOUtils.scala:46-139``
via Hadoop input formats). A copy of ``photon_ml_tpu/io/avro.py``, so the
two packages write the same bytes; it needs no avro/fastavro package. It
is a from-scratch implementation of the Avro 1.x spec subset the
Photon formats need: null/boolean/int/long/float/double/string/bytes,
records, arrays, maps, unions, enums, fixed; object container files with
null or deflate codecs; named-type references.

Host-side only (ingest/export); nothing here touches the device path.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, BinaryIO, Dict, Iterable, List, Tuple, Union

MAGIC = b"Obj\x01"

SchemaType = Union[str, dict, list]


# ---------------------------------------------------------------------------
# primitive encode/decode
# ---------------------------------------------------------------------------


def _encode_long(n: int) -> bytes:
    """zigzag + varint."""
    n = (n << 1) ^ (n >> 63)
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _decode_long(buf: BinaryIO) -> int:
    shift = 0
    acc = 0
    while True:
        (b,) = buf.read(1)
        acc |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1)


def _encode_string(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _encode_long(len(raw)) + raw


def _decode_bytes(buf: BinaryIO) -> bytes:
    return buf.read(_decode_long(buf))


# ---------------------------------------------------------------------------
# schema-driven encode/decode
# ---------------------------------------------------------------------------


class _Names:
    """Named-type registry: records/enums/fixed referenced by (full)name."""

    def __init__(self):
        self.types: Dict[str, dict] = {}

    def register(self, schema: dict):
        name = schema["name"]
        ns = schema.get("namespace")
        self.types[name] = schema
        if ns:
            self.types[f"{ns}.{name}"] = schema

    def resolve(self, ref: str) -> SchemaType:
        return self.types.get(ref, ref)


_PRIMITIVES = {
    "null", "boolean", "int", "long", "float", "double", "string", "bytes",
}


def _register_all(schema: SchemaType, names: _Names):
    """Walk a schema and register every named type up front, so by-name
    references resolve even when no VALUE of the declaring type has been
    seen yet (e.g. an empty array field preceding a by-name reference)."""
    if isinstance(schema, list):
        for branch in schema:
            _register_all(branch, names)
    elif isinstance(schema, dict):
        t = schema["type"]
        if t in ("record", "enum", "fixed"):
            names.register(schema)
        if t == "record":
            for f in schema["fields"]:
                _register_all(f["type"], names)
        elif t == "array":
            _register_all(schema["items"], names)
        elif t == "map":
            _register_all(schema["values"], names)


def _encode(schema: SchemaType, value: Any, names: _Names, out: bytearray):
    if isinstance(schema, str) and schema not in _PRIMITIVES:
        schema = names.resolve(schema)
    if isinstance(schema, str):
        if schema == "null":
            return
        if schema == "boolean":
            out.append(1 if value else 0)
        elif schema in ("int", "long"):
            out += _encode_long(int(value))
        elif schema == "float":
            out += struct.pack("<f", float(value))
        elif schema == "double":
            out += struct.pack("<d", float(value))
        elif schema == "string":
            out += _encode_string(value)
        elif schema == "bytes":
            out += _encode_long(len(value)) + bytes(value)
        else:
            raise ValueError(f"unresolved schema reference {schema!r}")
        return
    if isinstance(schema, list):  # union: pick first matching branch
        idx = _union_branch(schema, value, names)
        out += _encode_long(idx)
        _encode(schema[idx], value, names, out)
        return
    t = schema["type"]
    if t == "record":
        names.register(schema)
        for f in schema["fields"]:
            if f["name"] not in value and "default" in f:
                _encode(f["type"], f["default"], names, out)
            else:
                _encode(f["type"], value[f["name"]], names, out)
    elif t == "array":
        if value:
            out += _encode_long(len(value))
            for item in value:
                _encode(schema["items"], item, names, out)
        out += _encode_long(0)
    elif t == "map":
        if value:
            out += _encode_long(len(value))
            for k, v in value.items():
                out += _encode_string(k)
                _encode(schema["values"], v, names, out)
        out += _encode_long(0)
    elif t == "enum":
        names.register(schema)
        out += _encode_long(schema["symbols"].index(value))
    elif t == "fixed":
        names.register(schema)
        out += bytes(value)
    elif t in _PRIMITIVES:
        _encode(t, value, names, out)
    else:
        raise ValueError(f"unsupported schema {schema!r}")


def _union_branch(union: list, value: Any, names: _Names) -> int:
    for i, branch in enumerate(union):
        b = names.resolve(branch) if isinstance(branch, str) else branch
        if b == "null" and value is None:
            return i
        if b != "null" and value is not None:
            if isinstance(b, str):
                if b == "boolean" and isinstance(value, bool):
                    return i
                if b in ("int", "long") and isinstance(value, int):
                    return i
                if b in ("float", "double") and isinstance(value, (int, float)):
                    return i
                if b == "string" and isinstance(value, str):
                    return i
                if b == "bytes" and isinstance(value, (bytes, bytearray)):
                    return i
            elif isinstance(b, dict):
                t = b["type"]
                if t == "record" and isinstance(value, dict):
                    return i
                if t == "array" and isinstance(value, (list, tuple)):
                    return i
                if t == "map" and isinstance(value, dict):
                    return i
                if t == "enum" and isinstance(value, str):
                    return i
    raise ValueError(f"no union branch of {union!r} accepts {value!r}")


def _decode(schema: SchemaType, buf: BinaryIO, names: _Names) -> Any:
    if isinstance(schema, str) and schema not in _PRIMITIVES:
        schema = names.resolve(schema)
    if isinstance(schema, str):
        if schema == "null":
            return None
        if schema == "boolean":
            return buf.read(1) != b"\x00"
        if schema in ("int", "long"):
            return _decode_long(buf)
        if schema == "float":
            return struct.unpack("<f", buf.read(4))[0]
        if schema == "double":
            return struct.unpack("<d", buf.read(8))[0]
        if schema == "string":
            return _decode_bytes(buf).decode("utf-8")
        if schema == "bytes":
            return _decode_bytes(buf)
        raise ValueError(f"unresolved schema reference {schema!r}")
    if isinstance(schema, list):
        return _decode(schema[_decode_long(buf)], buf, names)
    t = schema["type"]
    if t == "record":
        names.register(schema)
        return {
            f["name"]: _decode(f["type"], buf, names)
            for f in schema["fields"]
        }
    if t == "array":
        items = []
        while True:
            count = _decode_long(buf)
            if count == 0:
                return items
            if count < 0:  # block with byte size prefix
                _decode_long(buf)
                count = -count
            for _ in range(count):
                items.append(_decode(schema["items"], buf, names))
    if t == "map":
        result = {}
        while True:
            count = _decode_long(buf)
            if count == 0:
                return result
            if count < 0:
                _decode_long(buf)
                count = -count
            for _ in range(count):
                k = _decode_bytes(buf).decode("utf-8")
                result[k] = _decode(schema["values"], buf, names)
    if t == "enum":
        names.register(schema)
        return schema["symbols"][_decode_long(buf)]
    if t == "fixed":
        names.register(schema)
        return buf.read(schema["size"])
    if t in _PRIMITIVES:
        return _decode(t, buf, names)
    raise ValueError(f"unsupported schema {schema!r}")


# ---------------------------------------------------------------------------
# object container files
# ---------------------------------------------------------------------------


def write_avro_file(
    path: str,
    schema: dict,
    records: Iterable[dict],
    codec: str = "deflate",
    sync_marker: bytes = None,
    block_size: int = 4096,
):
    """Write an Avro object container file (``avro/AvroIOUtils.scala``'s
    saveAsSingleAvro analog). The sync marker is random per file as the
    spec requires — split-seeking readers scan for it, so a fixed marker
    risks resync-on-payload-bytes collisions."""
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported codec {codec!r}")
    if sync_marker is None:
        sync_marker = os.urandom(16)
    if len(sync_marker) != 16:
        raise ValueError("sync_marker must be 16 bytes")
    names = _Names()
    _register_all(schema, names)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(MAGIC)
        meta = {
            "avro.schema": json.dumps(schema).encode(),
            "avro.codec": codec.encode(),
        }
        header = bytearray()
        header += _encode_long(len(meta))
        for k, v in meta.items():
            header += _encode_string(k)
            header += _encode_long(len(v)) + v
        header += _encode_long(0)
        f.write(header)
        f.write(sync_marker)

        block = bytearray()
        count = 0

        def flush():
            nonlocal block, count
            if not count:
                return
            data = bytes(block)
            if codec == "deflate":
                data = zlib.compress(data)[2:-4]  # raw deflate per spec
            f.write(_encode_long(count))
            f.write(_encode_long(len(data)))
            f.write(data)
            f.write(sync_marker)
            block = bytearray()
            count = 0

        for rec in records:
            _encode(schema, rec, names, block)
            count += 1
            if len(block) >= block_size:
                flush()
        flush()


def read_avro_file(path: str) -> Tuple[dict, List[dict]]:
    """Read a whole Avro object container file -> (schema, records)."""
    with open(path, "rb") as f:
        raw = f.read()
    buf = io.BytesIO(raw)
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
    schema = json.loads(meta["avro.schema"])
    codec = meta.get("avro.codec", b"null").decode()
    sync = buf.read(16)

    names = _Names()
    _register_all(schema, names)
    records: List[dict] = []
    while buf.tell() < len(raw):
        count = _decode_long(buf)
        size = _decode_long(buf)
        data = buf.read(size)
        if codec == "deflate":
            data = zlib.decompress(data, -15)
        elif codec != "null":
            raise ValueError(f"unsupported codec {codec!r}")
        bbuf = io.BytesIO(data)
        for _ in range(count):
            records.append(_decode(schema, bbuf, names))
        if buf.read(16) != sync:
            raise ValueError(f"{path}: bad sync marker (corrupt file)")
    return schema, records


def read_avro_dir(path: str) -> Tuple[dict, List[dict]]:
    """Read every part-*.avro / *.avro in a directory (the reference's
    hadoop-dir convention, ``avro/AvroIOUtils.scala:46-66``)."""
    schema = None
    records: List[dict] = []
    for fname in sorted(os.listdir(path)):
        if fname.endswith(".avro"):
            s, recs = read_avro_file(os.path.join(path, fname))
            schema = schema or s
            records.extend(recs)
    if schema is None:
        raise FileNotFoundError(f"no .avro files under {path}")
    return schema, records
