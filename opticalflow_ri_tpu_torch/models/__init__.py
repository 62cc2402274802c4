"""Optical-flow solvers (adapter protocol + tensor cores)."""
