"""Configuration dataclasses and device selection."""
