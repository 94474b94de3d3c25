"""Configuration and data generation."""
