"""Flat-buffer tree helpers and logging."""
