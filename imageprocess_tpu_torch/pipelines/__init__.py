"""Workload runners."""
