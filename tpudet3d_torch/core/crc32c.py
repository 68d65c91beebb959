"""Pure-python CRC32C (Castagnoli) and the TFRecord masking scheme (copy
of ``tpudet3d/core/crc32c.py``).

TFRecord framing (tf.data.TFRecordDataset verifies the masked length CRC
and raises DataLossError on a mismatch) is

    uint64 length | uint32 masked_crc32c(length_bytes) |
    byte   data[length] | uint32 masked_crc32c(data)

with ``masked = rotr(crc, 15) + 0xa282ead8 (mod 2^32)``, the scheme of the
Objectron eval shards.  Table-driven, byte at a time: eval shards are
small (tens of JPEG frames), so pure python is fast enough.
"""

import struct

__all__ = ['crc32c', 'masked_crc32c', 'tfrecord_frame']

_POLY = 0x82F63B78      # Castagnoli, reflected
_TABLE = None


def _table():
    global _TABLE
    if _TABLE is None:
        t = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ (_POLY if c & 1 else 0)
            t.append(c)
        _TABLE = t
    return _TABLE


def crc32c(data, crc=0):
    """CRC-32C of ``data`` (check value: crc32c(b'123456789')=0xE3069283)."""
    t = _table()
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ t[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data):
    """TFRecord-masked CRC: rotr15(crc) + 0xa282ead8 (mod 2^32)."""
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xa282ead8) & 0xFFFFFFFF


def tfrecord_frame(payload):
    """One complete TFRecord frame (length + both CRCs) for ``payload``."""
    length = struct.pack('<Q', len(payload))
    return (length + struct.pack('<I', masked_crc32c(length)) +
            payload + struct.pack('<I', masked_crc32c(payload)))
