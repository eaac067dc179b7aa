"""Measurement scripts of the port that run on an NVIDIA card (not imported by the
serving path)."""
