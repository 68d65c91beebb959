"""Protobuf wire decoding (copy of ``tpudet3d/data/converter``)."""
