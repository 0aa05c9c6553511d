"""Shared model substrate of the port."""
