"""Metric aggregation of saved TTO results."""
