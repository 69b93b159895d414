"""Helpers for runs without pretrained weights."""
