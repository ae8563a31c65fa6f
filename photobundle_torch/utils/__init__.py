"""Logging and timing helpers."""
