"""Utilities: dates, logging and device resolution."""
