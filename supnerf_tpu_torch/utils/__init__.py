"""Helpers of the entry points: image output."""
