"""Minimal protobuf wire-format reader: a copy of the wire decoder of
``tpudet3d/data/converter/proto.py`` (``_read_varint``, ``_skip`` and
``decode_message``), which the TFRecord ``tf.train.Example`` parser of
``eval/protocol.py`` uses.  The Objectron schemas and ``parse_sequence``
belong to the data slice.

Wire format essentials: each field is (tag = field_number << 3 | wire_type)
varint, then  0 = varint, 1 = fixed64, 2 = length-delimited, 5 = fixed32.
"""

import struct

__all__ = ['decode_message']


def _read_varint(buf, pos):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip(buf, pos, wire_type):
    if wire_type == 0:
        _, pos = _read_varint(buf, pos)
    elif wire_type == 1:
        pos += 8
    elif wire_type == 2:
        ln, pos = _read_varint(buf, pos)
        pos += ln
    elif wire_type == 5:
        pos += 4
    else:
        raise ValueError(f'unsupported wire type {wire_type}')
    return pos


def decode_message(buf, schema):
    """Decode one message given {field_number: (name, kind, sub)} where kind
    ∈ {'varint','float','double','string','message','packed_float'} and
    names ending in '[]' collect into lists."""
    out = {}
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field = tag >> 3
        wire = tag & 7
        spec = schema.get(field)
        if spec is None:
            pos = _skip(buf, pos, wire)
            continue
        name, kind, sub = spec
        repeated = name.endswith('[]')
        key = name[:-2] if repeated else name
        if kind == 'varint':
            val, pos = _read_varint(buf, pos)
        elif kind == 'float':
            if wire == 5:
                val = struct.unpack_from('<f', buf, pos)[0]
                pos += 4
            else:  # packed
                ln, pos = _read_varint(buf, pos)
                val = list(struct.unpack_from(f'<{ln // 4}f', buf, pos))
                pos += ln
                out.setdefault(key, []).extend(val) if repeated else None
                if repeated:
                    continue
        elif kind == 'double':
            if wire == 1:
                val = struct.unpack_from('<d', buf, pos)[0]
                pos += 8
            else:
                ln, pos = _read_varint(buf, pos)
                val = list(struct.unpack_from(f'<{ln // 8}d', buf, pos))
                pos += ln
                if repeated:
                    out.setdefault(key, []).extend(val)
                    continue
        elif kind == 'string':
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln].decode('utf-8', errors='replace')
            pos += ln
        elif kind == 'message':
            ln, pos = _read_varint(buf, pos)
            val = decode_message(buf[pos:pos + ln], sub)
            pos += ln
        else:
            raise ValueError(kind)
        if repeated:
            out.setdefault(key, []).append(val)
        else:
            out[key] = val
    return out
