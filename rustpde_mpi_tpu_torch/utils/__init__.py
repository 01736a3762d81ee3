"""Drivers around the models."""
