"""Host-side data readers (copies of ``tpudet3d/data``)."""
