"""Shared utilities: the analytic cost model and the roofline."""
