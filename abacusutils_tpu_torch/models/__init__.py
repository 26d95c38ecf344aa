"""The fused HOD step and its HOD helpers."""
