"""Differential-privacy configuration and accounting."""
