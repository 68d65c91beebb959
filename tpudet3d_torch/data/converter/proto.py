"""Minimal protobuf wire-format reader (a copy of
``tpudet3d/data/converter/proto.py``): the wire decoder, which the
TFRecord ``tf.train.Example`` parser of ``eval/protocol.py`` uses, and the
Objectron schema subset with ``parse_sequence`` for the converter.

Wire format essentials: each field is (tag = field_number << 3 | wire_type)
varint, then  0 = varint, 1 = fixed64, 2 = length-delimited, 5 = fixed32.
"""

import struct

__all__ = ['decode_message', 'parse_sequence']


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


# ---- Objectron schema subset -----------------------------------------------
# Field numbers pinned to the published Objectron protos (github
# google-research-datasets/Objectron, schema/{object,annotation_data,
# a_r_capture_metadata}.proto), the same generated modules the reference
# imports.  Every entry cites its source message below.

# annotation_data.proto message Point3D {float x=1; float y=2; float z=3;}
POINT3D = {1: ('x', 'float', None), 2: ('y', 'float', None),
           3: ('z', 'float', None)}
# annotation_data.proto message NormalizedPoint2D
# {float x=1; float y=2; float depth=3;}
POINT2D = {1: ('x', 'float', None), 2: ('y', 'float', None),
           3: ('depth', 'float', None)}

# annotation_data.proto message AnnotatedKeyPoint
# {int32 id=1; Point3D point_3d=2; NormalizedPoint2D point_2d=3;}
ANNOTATED_KEYPOINT = {
    1: ('id', 'varint', None),
    2: ('point_3d', 'message', POINT3D),
    3: ('point_2d', 'message', POINT2D),
}

# annotation_data.proto message ObjectAnnotation
# {int32 object_id=1; repeated AnnotatedKeyPoint keypoints=2;
#  float visibility=3;}
OBJECT_ANNOTATION = {
    1: ('object_id', 'varint', None),
    2: ('keypoints[]', 'message', ANNOTATED_KEYPOINT),
    3: ('visibility', 'float', None),
}

# a_r_capture_metadata.proto message ARCamera — mirrors ARKit's ARCamera
# property order: transform, eulerAngles, imageResolution, intrinsics,
# projectionMatrix, viewMatrix.
AR_CAMERA = {
    1: ('transform[]', 'float', None),          # 4x4 row-major pose
    2: ('euler_angles[]', 'float', None),       # 3x1
    3: ('image_resolution_width', 'float', None),
    4: ('image_resolution_height', 'float', None),
    5: ('intrinsics[]', 'float', None),         # 3x3 row-major
    6: ('projection_matrix[]', 'float', None),  # 4x4 row-major
    7: ('view_matrix[]', 'float', None),        # 4x4 row-major
}

# annotation_data.proto message FrameAnnotation
# {int32 frame_id=1; repeated ObjectAnnotation annotations=2;
#  ARCamera camera=3; double timestamp=4; repeated float plane_center=5;
#  repeated float plane_normal=6;}
FRAME_ANNOTATION = {
    1: ('frame_id', 'varint', None),
    2: ('annotations[]', 'message', OBJECT_ANNOTATION),
    3: ('camera', 'message', AR_CAMERA),
    4: ('timestamp', 'double', None),
    5: ('plane_center[]', 'float', None),
    6: ('plane_normal[]', 'float', None),
}

# object.proto message KeyPoint {float x=1; float y=2; float z=3;}
# object.proto message Object
# {int32 id=1; string category=2; Type type=3; repeated float rotation=4;
#  repeated float translation=5; repeated float scale=6;
#  repeated KeyPoint keypoints=7; Method method=8;}
# rotation/translation/scale come BEFORE keypoints.
OBJECT = {
    1: ('id', 'varint', None),
    2: ('category', 'string', None),
    3: ('type', 'varint', None),
    4: ('rotation[]', 'float', None),           # 3x3 row-major
    5: ('translation[]', 'float', None),        # 3x1, meters
    6: ('scale[]', 'float', None),              # 3x1
    7: ('keypoints[]', 'message', POINT3D),
    8: ('method', 'varint', None),
}

# annotation_data.proto message Sequence
# {repeated Object objects=1; repeated FrameAnnotation frame_annotations=2;}
SEQUENCE = {
    1: ('objects[]', 'message', OBJECT),
    2: ('frame_annotations[]', 'message', FRAME_ANNOTATION),
}


def parse_sequence(data: bytes):
    """Objectron .pbdata bytes → nested dict per SEQUENCE schema."""
    return decode_message(data, SEQUENCE)
