"""Configuration and numeric settings."""
