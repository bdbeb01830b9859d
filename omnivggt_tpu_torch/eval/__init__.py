"""Trajectory evaluation."""
