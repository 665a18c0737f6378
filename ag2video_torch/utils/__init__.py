"""Utilities: visualization artifacts."""
