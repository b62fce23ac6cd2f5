"""Pose, box, ray and ROI geometry on torch tensors (and numpy for host prep)."""
